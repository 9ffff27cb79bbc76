"""Time the port's int4 kernels on the card at the int4 path's shapes
(Llama-3.2-3B, 28 layers) for one checkout's kernels, so that two checkouts
can be compared in turns in one call.

Prefill (the W4A16 kernel past 64 rows), at M 1526 (B = 1's prefix) and
6104 (B = 4's): the four stacked products, q|k|v (N 5120) and gate|up (N
16384) as two planes, o (K 3072, N 3072) and down (K 8192, N 3072) as one
row, whole K and, where K is 3072, the K-split at block_k 768 and 1536;
the unstacked q_proj (K 3072, N 3072) and down_proj (K 8192, N 3072). Each
at every scale group given (gate|up at 6104 also at `--gate-up-groups`),
its ms by CUPTI over 10 calls after 3 warm-up calls (the layer rotating),
beside its bound (2 M K N FLOP at 989 TFLOP/s, or the bytes at 3.35 TB/s,
whichever is longer) and cuBLAS's bf16 product `x @ w` on the dequantized
weight (a yardstick the port never calls). Decode (M 4: q|k|v whole K and
bk 768; the fused MLP) by CUDA events over 20 calls. The timers and the
bound are chip_smoke.py's, from the checkout that holds this script; the
kernels are those of --checkout (default: this one). Prints one JSON line
and the card's name and power limit:

    python scripts/int4_group_timing.py --checkout <dir> 128 32
"""
import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
L, D, Fd, Nqkv, Nq, B = 28, 3072, 8192, 5120, 3072, 4
PREFILL_M = (1526, 6104)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("groups", nargs="*", type=int, default=[128])
    ap.add_argument("--checkout", default=str(ROOT), help="the checkout whose kernels are timed")
    ap.add_argument("--gate-up-groups", nargs="*", type=int, default=[],
                    help="more groups for gate|up at M 6104 alone")
    ap.add_argument("--no-decode", action="store_true", help="the prefill shapes only")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.checkout).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    from audio_llama_tpu_torch.ops import _cuda
    from audio_llama_tpu_torch.ops import int4_matmul as i4
    from audio_llama_tpu_torch.ops import mlp_int4 as mlp4

    print(f"kernels: {_cuda.build()}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def rb(*s):
        return torch.randint(-128, 128, s, generator=gen, device=dev, dtype=torch.int32).to(
            torch.int8)

    def rs(*s):
        return torch.rand(s, generator=gen, device=dev) * 0.02 + 0.002

    def events(fn, iters=20):
        for i in range(3):
            fn(i)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for i in range(iters):
            fn(i)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    def cupti(fn):
        turn = iter(range(10 ** 6))
        return float(cs.time_ms(lambda: fn(next(turn)), iters=10))

    xs = {M: torch.randn((M, 8192), generator=gen, device=dev).to(bf) for M in PREFILL_M}
    out = {}

    def prefill(label, K, N, groups, stacked, planes=False, ksplit=False, ms=PREFILL_M):
        for M in ms:
            x = xs[M][:, :K].contiguous()
            entry = out.setdefault(f"{label} M {M}", {})
            entry["bound_ms"], entry["bound_by"] = cs.bound(
                2.0 * M * K * N, K * N / 2 + (K / 128) * N * 4 + 2.0 * M * (K + N))
            for g in groups:
                if stacked:
                    p, s = rb(L, K, N // 2), rs(L, K // g, N)
                    for bk in (0, 768, 1536) if ksplit else (0,):
                        key = f"g{g} ms" + (f" bk{bk}" if bk else "")
                        entry[key] = cupti(lambda i: i4.int4_matmul_stacked_cuda(
                            x, p, s, i % L, g, return_planes=planes, block_k=bk))
                    w = i4.dequantize_ref(p[0], s[0], g).to(bf)
                else:
                    p, s = rb(K, N // 2), rs(K // g, N)
                    entry[f"g{g} ms"] = cupti(lambda i: i4.int4_matmul_cuda(x, p, s, g))
                    w = i4.dequantize_ref(p, s, g).to(bf)
                if "library_ms" not in entry:  # cuBLAS's time does not depend on the group
                    entry["library_ms"] = cupti(lambda i: x @ w)
                del p, s, w
                torch.cuda.empty_cache()
            print(json.dumps({f"{label} M {M}": entry}), flush=True)

    g = args.groups
    prefill("stacked q|k|v", D, Nqkv, g, True, planes=True, ksplit=True)
    prefill("stacked o", Nq, D, g, True, ksplit=True)
    prefill("stacked gate|up", D, 2 * Fd, g, True, planes=True, ksplit=True)
    if args.gate_up_groups:
        prefill("stacked gate|up", D, 2 * Fd, args.gate_up_groups, True, planes=True,
                ksplit=True, ms=(6104,))
    prefill("stacked down", Fd, D, g, True)
    prefill("unstacked q_proj", D, Nq, g, False)
    prefill("unstacked down_proj", Fd, D, g, False)
    if not args.no_decode:
        x4 = torch.randn((B, D), generator=gen, device=dev).to(bf)
        for grp in g:
            p, s = rb(L, D, Nqkv // 2), rs(L, D // grp, Nqkv)
            out[f"g{grp} decode q|k|v"] = events(
                lambda i: i4.int4_matmul_stacked_cuda(x4, p, s, i % L, grp))
            out[f"g{grp} decode q|k|v bk768"] = events(
                lambda i: i4.int4_matmul_stacked_cuda(x4, p, s, i % L, grp, block_k=768))
            p, s = rb(L, D, Fd), rs(L, D // grp, 2 * Fd)
            dn, dns = rb(L, Fd, D // 2), rs(L, Fd // grp, D)
            chunk = mlp4.kernel_chunk(Fd, D // 2, grp)
            out[f"g{grp} mlp"] = events(lambda i: mlp4.mlp_int4_stacked_cuda(
                x4, p, s, dn, dns, i % L, grp, chunk))
            del p, s, dn, dns
    print(json.dumps(out), flush=True)
    print(cs.gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
