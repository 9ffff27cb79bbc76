"""Time the causal forward kernels and their SDPA yardsticks on the card, so
that two checkouts can be compared in one call.

At chip_smoke.py's phase 18 geometry (`variant_case`: T 2560, Hq 24, Hkv 8,
hd 128) each variant's kernel (cond, bounded, twopass, dma, dma2), the online
'always' kernel and SDPA (is_causal, enable_gqa); at row 3's shape
(`prefill_attention_case`: B 1, T 1536, 1526 real) the online 'always'
kernel beside SDPA with is_causal on the unrepeated K/V and the earlier
masked SDPA; at row 3n's hop (`ring_hop_case`: B 2, T 1024, the sp = 2 hop
of train A) the 'never' kernel beside SDPA with no mask. The timer is
chip_smoke's `time_ms` (CUPTI device time over 20 calls after 3 warm-up
calls), from the checkout that holds this script. The kernels are those of
the checkout named by --checkout (default: this one): its
`audio_llama_tpu_torch` is imported and built in place of this one's.
Prints one JSON line {"<case> <name>": ms, "timed_by": [...]} and the card's
name and power limit:

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
    ap.add_argument("--batch", type=int, nargs="+", default=[2],
                    help="batch sizes of the phase 18 geometry")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.checkout).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch
    import torch.nn.functional as F

    from audio_llama_tpu_torch.ops import _cuda
    from audio_llama_tpu_torch.ops import causal_attention as ca

    print(f"kernels: {_cuda.build()}", flush=True)
    dev = torch.device("cuda", 0)
    cases = []
    for B in args.batch:
        case = cs.variant_case(dev, torch.Generator(device=dev).manual_seed(B), B)
        calls = {name: (lambda name=name, case=case: cs.variant_call(name, case))
                 for name in cs.VARIANT_ROWS}
        calls["causal_attention (always)"] = lambda case=case: ca.causal_attention_cuda(
            case["qs"], case["k"], case["v"], case["key_bias"])
        calls["sdpa"] = cs.variant_sdpa(case)
        cases.append((f"B={B}", calls))
    pre = cs.prefill_attention_case(dev, torch.Generator(device=dev).manual_seed(3))
    sdpa, sdpa_masked = cs.prefill_sdpa(pre)
    cases.append(("row 3", {
        "causal_attention": lambda: ca.causal_attention_cuda(pre["qs"], pre["k"], pre["v"],
                                                             pre["key_bias"]),
        "sdpa (is_causal, enable_gqa)": sdpa, "sdpa (boolean mask, K/V repeated)": sdpa_masked}))
    lc = cs.full_config().llama
    T = cs.TRAIN_T // 2
    hop = cs.ring_hop_case(dev, torch.Generator(device=dev).manual_seed(12), cs.TRAIN_B, T,
                           lc.num_heads, lc.num_kv_heads, lc.head_dim, pad_from=T * 7 // 8)
    qh, kh, vh = (hop[n].transpose(1, 2) for n in ("qs", "k", "v"))
    cases.append(("row 3n", {
        "causal_attention_never": lambda: ca.causal_attention_cuda(hop["qs"], hop["k"], hop["v"],
                                                                   hop["bias"], "never"),
        "sdpa (no mask, enable_gqa)": lambda: F.scaled_dot_product_attention(
            qh, kh, vh, scale=1.0, enable_gqa=True)}))
    out, by = {}, set()
    for label, calls in cases:
        for name, fn in calls.items():
            ms = cs.time_ms(fn)
            out[f"{label} {name}"], by = float(ms), by | {ms.by}
    out["timed_by"] = sorted(by)
    print(json.dumps(out), flush=True)
    print(cs.gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
