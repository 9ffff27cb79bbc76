"""Time and profile the bf16 B = 1 prefill of chip_smoke.py's main path for
one checkout's kernels, so that two checkouts can be compared in one call.

The model and request (`bf16_request`: seeded full-width weights, a 30 s
log-mel clip, a 24-token prompt) and the timers (`synced_ms`, the host
clock around a synchronised call; `device_profile`, CUPTI) are chip_smoke.py's,
from the checkout that holds this script; the kernels are those of the
checkout named by --checkout (default: this one). After a warm-up, the
encoder alone and `generate` for one token (encode + project + splice +
prefill + first token) are each timed --repeats times in turn;
chip_smoke's prefill_ms is the difference of their minima. Then one
profiled call of each gives device time, busy share and time by kernel
group. Prints one JSON line and the card's name and power limit:

    python scripts/prefill_timing.py --checkout <dir> --repeats 7
"""
import argparse
import importlib.util
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkout", default=str(ROOT),
                    help="the checkout whose kernels are timed")
    ap.add_argument("--repeats", type=int, default=7)
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
    cfg, frozen, trainable, ids, mask, mel, run = cs.bf16_request(dev)

    def encode():
        return allm.process_audio_features(frozen, cfg, mel)

    run(2)  # warm-up: library handles, allocator
    enc, first = [], []
    for _ in range(args.repeats):
        enc.append(cs.synced_ms(encode))
        first.append(cs.synced_ms(lambda: run(1)))
    out = {
        "encode_ms": enc, "first_token_ms": first,
        "prefill_ms (min first - min encode)": min(first) - min(enc),
        "prefill_ms (median first - median encode)": (statistics.median(first)
                                                      - statistics.median(enc)),
        "profile_first_token": cs.device_profile(lambda: run(1)),
        "profile_encode": cs.device_profile(encode),
    }
    print(json.dumps(out), flush=True)
    print(cs.gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
