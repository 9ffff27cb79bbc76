"""Time the causal forward variants' kernels (cond, bounded, twopass, dma,
dma2) and SDPA on the card, so that two checkouts can be compared in one call.

The geometry (`variant_case`), the calls (`variant_call`, `variant_sdpa`)
and the timer (`time_ms`, CUPTI device time over 20 calls after 3 warm-up
calls) are chip_smoke.py's phase 18, from the checkout that holds this
script. The kernels are those of the checkout named by --checkout (default:
this one): its `audio_llama_tpu_torch` is imported and built in place of
this one's. Prints one JSON line {"B=b name": ms, "timed_by": [...]} and the
card's name and power limit:

    python scripts/causal_variant_timing.py --checkout <dir> --batch 2 8
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
    ap.add_argument("--batch", type=int, nargs="+", default=[2])
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.checkout).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    from audio_llama_tpu_torch.ops import _cuda

    print(f"kernels: {_cuda.build()}", flush=True)
    dev = torch.device("cuda", 0)
    out, by = {}, set()
    for B in args.batch:
        case = cs.variant_case(dev, torch.Generator(device=dev).manual_seed(B), B)
        calls = {name: (lambda name=name: cs.variant_call(name, case)) for name in cs.VARIANT_ROWS}
        calls["sdpa"] = cs.variant_sdpa(case)
        for name, fn in calls.items():
            ms = cs.time_ms(fn)
            out[f"B={B} {name}"], by = float(ms), by | {ms.by}
        del case, calls
        torch.cuda.empty_cache()
    out["timed_by"] = sorted(by)
    print(json.dumps(out), flush=True)
    print(cs.gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
