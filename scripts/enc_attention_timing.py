"""Time the encoder attention kernels and their SDPA yardsticks on the card,
so that two checkouts can be compared in one call.

At chip_smoke.py's encoder geometry (`enc_case`: q/k/v [B, 1536, 20, 64]
bf16 views of [B, 1536, 1280] projections, 1500 valid keys, q pre-scaled)
for each batch size: row 2 (`enc_attention_cuda`, the online softmax), row
21 (the bounded shift) in the projection layout and head-major, row 22 (the
two-pass softmax) in both layouts and with the bf16 exp argument, and SDPA
with no mask on K/V cut to the valid keys (its backend named). The timer is
chip_smoke's `time_ms` (CUPTI device time over 20 calls after 3 warm-up
calls), from the checkout that holds this script. The kernels are those of
the checkout named by --checkout (default: this one): its
`audio_llama_tpu_torch` is imported and built in place of this one's. With
--enc8, chip_smoke's `enc8_path` (the W8A8 encoder at B 8 in every
--enc_algo, the bf16 encoder beside it) runs after the kernels and logs its
encode_ms. Prints one JSON line {"B=<b> <name>": ms, ..., "timed_by": [...]}
and the card's name and power limit:

    python scripts/enc_attention_timing.py --checkout <dir> --batch 1 4 8 --enc8
"""
import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkout", default=str(ROOT),
                    help="the checkout whose kernels are timed")
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 4, 8],
                    help="batch sizes of the encoder geometry")
    ap.add_argument("--enc8", action="store_true",
                    help="also run chip_smoke's enc8_path (encode_ms by --enc_algo at B 8)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.checkout).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    from audio_llama_tpu_torch.ops import _cuda

    print(f"kernels: {_cuda.build()}", flush=True)
    dev = torch.device("cuda", 0)
    arms = {"enc_attention": {}, "enc_attention_bounded": {},
            "enc_attention_bounded head-major": {"layout": "head-major"},
            "enc_attention_twopass": {},
            "enc_attention_twopass head-major": {"layout": "head-major"},
            "enc_attention_twopass exp_bf16": {"exp_dtype": torch.bfloat16}}
    out, by = {}, set()
    for B in args.batch:
        case = cs.enc_case(dev, torch.Generator(device=dev).manual_seed(B), B)
        calls = {label: (lambda label=label, kw=kw: cs.enc_call(label.split()[0], case, **kw))
                 for label, kw in arms.items()}
        sdpa, _ = cs.enc_sdpa(case["qs"], case["k"], case["v"], case["valid"])
        calls["sdpa (no mask, valid keys)"] = sdpa
        for name, fn in calls.items():
            ms = cs.time_ms(fn)
            out[f"B={B} {name}"], by = float(ms), by | {ms.by}
        out[f"B={B} sdpa backend"] = cs.sdpa_backend(sdpa)
        out[f"B={B} bound_ms"] = cs.bound(*cs.enc_work("enc_attention", B, 1536, 20, 64,
                                                       case["valid"]))[0]
        del case, calls, sdpa
        torch.cuda.empty_cache()
    out["timed_by"] = sorted(by)
    print(json.dumps(out), flush=True)
    if args.enc8:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cs.enc8_path(dev)
    print(cs.gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
