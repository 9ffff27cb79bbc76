"""Time and profile the prefill of chip_smoke.py's serving paths for one
checkout's kernels, so that two checkouts can be compared in one call.

The models and requests are chip_smoke's: `bf16` (`bf16_request`: seeded
full-width bf16 weights, a 30 s log-mel clip, a 24-token prompt), `int4`
(`int4_request`: the fused int4 tree, four 30 s waveforms, B = 4) and
`int4_b1` (`int4_request(b1=True)`: the rotated int4 tree, one waveform);
so are the timers (`synced_ms`, the host clock around a synchronised call;
`device_profile`, CUPTI). The kernels are those of the checkout named by
--checkout (default: this one). Per request, after a warm-up, the encoder
alone and `generate` for one token (encode + project + splice + prefill +
first token) are each timed --repeats times in turn; chip_smoke's
prefill_ms is the difference of their minima. Then one profiled call of
each gives device time, busy share and time by kernel group. Prints one
JSON line a request and the card's name and power limit:

    python scripts/prefill_timing.py --checkout <dir> --repeats 7 --requests int4 int4_b1
"""
import argparse
import importlib.util
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
REQUESTS = ("bf16", "int4", "int4_b1")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkout", default=str(ROOT),
                    help="the checkout whose kernels are timed")
    ap.add_argument("--repeats", type=int, default=7)
    ap.add_argument("--requests", nargs="+", default=["bf16"], choices=REQUESTS)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.checkout).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    from audio_llama_tpu_torch.models import allm
    from audio_llama_tpu_torch.ops import _cuda

    print(f"kernels: {_cuda.build()}", flush=True)
    dev = torch.device("cuda", 0)
    for name in args.requests:
        if name == "bf16":
            cfg, frozen, trainable, ids, mask, audio, run = cs.bf16_request(dev)
        else:
            cfg, frozen, trainable, ids, mask, audio, run, _ = cs.int4_request(
                dev, b1=name == "int4_b1")

        def encode():
            return allm.process_audio_features(frozen, cfg, audio)

        run(2)  # warm-up: library handles, allocator
        enc, first = [], []
        for _ in range(args.repeats):
            enc.append(cs.synced_ms(encode))
            first.append(cs.synced_ms(lambda: run(1)))
        out = {
            "request": name, "batch": ids.shape[0], "encode_ms": enc, "first_token_ms": first,
            "prefill_ms (min first - min encode)": min(first) - min(enc),
            "prefill_ms (median first - median encode)": (statistics.median(first)
                                                          - statistics.median(enc)),
            "profile_first_token": cs.device_profile(lambda: run(1)),
            "profile_encode": cs.device_profile(encode),
        }
        print(json.dumps(out), flush=True)
        del frozen, trainable, run
        torch.cuda.empty_cache()
    print(cs.gpu_line(), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
