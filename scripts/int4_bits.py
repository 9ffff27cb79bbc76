"""Fingerprint the int4 kernels' outputs on seeded inputs, so that two
checkouts can be shown to give the same bits.

The W4A16 prefill shape (`w4_wgmma_kernel`, past 64 rows) at the int4 path's
6104 rows: q|k|v (N 5120, two planes) at groups 128 and 32, whole K and at
block_k 768, gate|up (N 16384) and down (K 8192) at group 128; the decode
megakernel (row 9, `decode_megakernel`) on chip_smoke's 28-layer case (both
pack formats, offset 1567 of 1568 slots): its hidden row, cache and scale
slabs. Every input is made from fixed seeds; the kernels are those of the
checkout named by --checkout (default: this one), the case builders those
of the chip_smoke.py beside this script. Prints one JSON line {"<output>":
sha256 prefix of its bytes} and the card's name and power limit; two
checkouts give the same bits where their lines are equal:

    python scripts/int4_bits.py --checkout <dir>
"""
import argparse
import hashlib
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
M_PRE, L, D, Fd, Nqkv = 6104, 28, 3072, 8192, 5120


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkout", default=str(ROOT), help="the checkout whose kernels are run")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.checkout).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    from audio_llama_tpu_torch.ops import _cuda
    from audio_llama_tpu_torch.ops import decode_megakernel as mk
    from audio_llama_tpu_torch.ops import int4_matmul as i4

    print(f"kernels: {_cuda.build()}", flush=True)
    dev = torch.device("cuda", 0)
    outs = {}

    def seeded(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    for label, K, N, group, bk, seed in (("q|k|v", D, Nqkv, 128, 0, 1),
                                        ("q|k|v", D, Nqkv, 128, 768, 1),
                                        ("q|k|v", D, Nqkv, 32, 0, 2),
                                        ("gate|up", D, 2 * Fd, 128, 0, 3),
                                        ("down", Fd, D, 128, 0, 4)):
        g = seeded(seed)
        packed = torch.randint(-128, 128, (2, K, N // 2), generator=g, device=dev,
                               dtype=torch.int32).to(torch.int8)
        scales = torch.rand((2, K // group, N), generator=g, device=dev) * 0.02 + 0.002
        x = torch.randn((M_PRE, K), generator=g, device=dev).to(torch.bfloat16)
        outs[f"prefill {label} group {group} bk {bk}"] = i4.int4_matmul_stacked_cuda(
            x, packed, scales, 1, group, block_k=bk)
        del packed, scales, x
    for fmt in ("pair", "obin"):
        case = cs.megakernel_case(dev, seeded(9), fmt, L, 1568, 1567)
        hidden, cache, ks, vs, _ = cs.mega_run(mk.decode_megakernel_cuda, case)
        outs.update({f"megakernel {fmt} hidden": hidden, f"megakernel {fmt} cache": cache,
                     f"megakernel {fmt} k_scales": ks, f"megakernel {fmt} v_scales": vs})
    torch.cuda.synchronize()
    digest = {name: hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
              .hexdigest()[:16] for name, t in outs.items()}
    print(json.dumps(digest), flush=True)
    print(cs.gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
