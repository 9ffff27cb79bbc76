"""Fingerprint the causal attention forwards' outputs on seeded inputs, so that
two checkouts can be shown to give the same bits.

Row 3 (`prefill_attention_case`: the online 'always' kernel at B 1, T 1536),
row 3n (`ring_hop_case`: the 'never' kernel at the sp = 2 hop of train A)
and rows 23-27 (`variant_case` at B 2, T 2560: cond, bounded, twopass, dma,
dma2), each kernel once on inputs made from fixed seeds by the chip_smoke.py
of the checkout that holds this script. The kernels are those of the
checkout named by --checkout (default: this one). Prints one JSON line
{"<row> <output>": sha256 of its bytes} and the card's name and power limit;
two checkouts give the same bits where their lines are equal:

    python scripts/attention_bits.py --checkout <dir>
"""
import argparse
import hashlib
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkout", default=str(ROOT),
                    help="the checkout whose kernels are run")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.checkout).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    from audio_llama_tpu_torch.ops import _cuda
    from audio_llama_tpu_torch.ops import causal_attention as ca

    print(f"kernels: {_cuda.build()}", flush=True)
    dev = torch.device("cuda", 0)
    outs = {}
    pre = cs.prefill_attention_case(dev, torch.Generator(device=dev).manual_seed(3))
    outs["row 3"] = ca.causal_attention_cuda(pre["qs"], pre["k"], pre["v"], pre["key_bias"])
    lc = cs.full_config().llama
    T = cs.TRAIN_T // 2
    hop = cs.ring_hop_case(dev, torch.Generator(device=dev).manual_seed(12), cs.TRAIN_B, T,
                           lc.num_heads, lc.num_kv_heads, lc.head_dim, pad_from=T * 7 // 8)
    outs["row 3n"] = ca.causal_attention_cuda(hop["qs"], hop["k"], hop["v"], hop["bias"], "never")
    case = cs.variant_case(dev, torch.Generator(device=dev).manual_seed(2), 2)
    for name in cs.VARIANT_ROWS:
        outs[name] = cs.variant_call(name, case)
    torch.cuda.synchronize()
    digest = {f"{row} {field}": hashlib.sha256(
                  getattr(out, field).contiguous().view(torch.uint8).cpu().numpy().tobytes())
              .hexdigest()[:16]
              for row, out in outs.items() for field in ("o", "l", "m")}
    print(json.dumps(digest), flush=True)
    print(cs.gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
