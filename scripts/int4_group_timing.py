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
weight (a yardstick the port never calls).

Decode (the W4A16 up to 64 rows and the fused MLP), at the rows of
`--decode-rows` (1, 4, 16, 64): q|k|v (two planes) and o, stacked, whole K
and at block_k 768 and 1536, rotating over the 28 layers; the unstacked
q_proj and down_proj rotating over copies of the weight that together
exceed the 50 MB L2; the MLP (rows 7 and 7r: without and with a down
equalizer dn_r) rotating over the layers. Each at every group given, by
CUPTI over 56 calls, beside its bound and two yardsticks (unless
`--no-library`): the same product in PyTorch on the dequantized bf16
weight (`x @ w`; the MLP's three matmuls and SiLU) on one weight
(`library_ms_hot`) and rotating over dequantized layers past the L2
(`library_ms`). The timers and the bound are chip_smoke.py's, from the
checkout that holds this script; the kernels are those of --checkout
(default: this one). Prints JSON lines and the card's name and power
limit:

    python scripts/int4_group_timing.py --checkout <dir> 128 32
    python scripts/int4_group_timing.py --checkout <dir> --no-prefill 32 64 128 256
"""
import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
L, D, Fd, Nqkv, Nq, B = 28, 3072, 8192, 5120, 3072, 4
PREFILL_M = (1526, 6104)


def decode(cs, groups, rows, library, rb, rs, gen):
    """The decode shapes (module docstring), one JSON line an entry."""
    import torch
    import torch.nn.functional as F

    from audio_llama_tpu_torch.ops import int4_matmul as i4
    from audio_llama_tpu_torch.ops import mlp_int4 as mlp4

    dev, bf = torch.device("cuda"), torch.bfloat16
    xs = {M: torch.randn((M, Fd), generator=gen, device=dev).to(bf) for M in rows}

    def cupti(fn):
        turn = iter(range(10 ** 6))
        return float(cs.time_ms(lambda: fn(next(turn)), iters=56))

    def emit(key, entry):
        print(json.dumps({key: entry}), flush=True)

    for grp in groups:
        for label, K, N, stacked in (("q|k|v", D, Nqkv, True), ("o", Nq, D, True),
                                     ("q_proj", D, Nq, False), ("down_proj", Fd, D, False)):
            if K % grp:
                continue
            wbytes = K * N / 2 + (K / grp) * N * 4
            if stacked:
                p, s = rb(L, K, N // 2), rs(L, K // grp, N)
                weights = [(p[i], s[i]) for i in range(L)]
            else:
                weights = [(rb(K, N // 2), rs(K // grp, N)) for _ in range(cs.cold_layers(wbytes))]
            if library:
                n = cs.cold_layers(2.0 * K * N)
                w_rot = [i4.dequantize_ref(*weights[i], grp).to(bf) for i in range(n)]
            for M in rows:
                x = xs[M][:, :K].contiguous()
                entry = dict(zip(("bound_ms", "bound_by"), cs.bound(
                    2.0 * M * K * N, wbytes + 2.0 * M * (K + N))))
                if stacked:
                    for bk in (0, 768, 1536) if K % 768 == 0 else (0,):
                        entry["ms" + (f" bk{bk}" if bk else "")] = cupti(
                            lambda i: i4.int4_matmul_stacked_cuda(
                                x, p, s, i % L, grp, return_planes=label == "q|k|v",
                                block_k=bk))
                else:
                    entry["ms"] = cupti(lambda i: i4.int4_matmul_cuda(
                        x, *weights[i % len(weights)], grp))
                if library:
                    entry["library_ms_hot"] = cupti(lambda i: x @ w_rot[0])
                    entry["library_ms"] = cupti(lambda i: x @ w_rot[i % n])
                emit(f"g{grp} decode {label} M {M}", entry)
            del weights
            if stacked:
                del p, s
            if library:
                del w_rot
            torch.cuda.empty_cache()
        # the fused MLP, without and with dn_r
        gp, gs = rb(L, D, Fd), rs(L, D // grp, 2 * Fd)
        dp, ds = rb(L, Fd, D // 2), rs(L, Fd // grp, D)
        dn_r = torch.rand((L, Fd), generator=gen, device=dev) + 0.5
        chunk = mlp4.kernel_chunk(Fd, D // 2, grp)
        nbytes = D * Fd + (D / grp) * 2 * Fd * 4 + Fd * D / 2 + (Fd / grp) * D * 4
        if library:
            n = cs.cold_layers(2.0 * D * 3 * Fd)
            w_rot = [(i4.dequantize_ref(gp[i], gs[i], grp).to(bf),
                      i4.dequantize_ref(dp[i], ds[i], grp).to(bf)) for i in range(n)]
        for M in rows:
            x = xs[M][:, :D].contiguous()
            for name, r in (("mlp", None), ("mlp dn_r", dn_r)):
                entry = dict(zip(("bound_ms", "bound_by"), cs.bound(
                    2.0 * M * D * 3 * Fd, nbytes + (0 if r is None else 4.0 * Fd)
                    + 4.0 * M * D)))
                entry["ms"] = cupti(lambda i: mlp4.mlp_int4_stacked_cuda(
                    x, gp, gs, dp, ds, i % L, grp, chunk, dn_r=r))
                if library:
                    r_bf = None if r is None else r[0].to(bf)

                    def three(i):
                        wg, wd = w_rot[i]
                        a = F.silu(x @ wg[:, :Fd]) * (x @ wg[:, Fd:])
                        return (a if r_bf is None else a * r_bf) @ wd

                    entry["library_ms_hot"] = cupti(lambda i: three(0))
                    entry["library_ms"] = cupti(lambda i: three(i % n))
                emit(f"g{grp} decode {name} M {M}", entry)
        del gp, gs, dp, ds, dn_r
        if library:
            del w_rot
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("groups", nargs="*", type=int, default=[128])
    ap.add_argument("--checkout", default=str(ROOT), help="the checkout whose kernels are timed")
    ap.add_argument("--gate-up-groups", nargs="*", type=int, default=[],
                    help="more groups for gate|up at M 6104 alone")
    ap.add_argument("--no-decode", action="store_true", help="the prefill shapes only")
    ap.add_argument("--no-prefill", action="store_true", help="the decode shapes only")
    ap.add_argument("--decode-rows", nargs="*", type=int, default=[1, 4, 16, 64])
    ap.add_argument("--no-library", action="store_true",
                    help="decode: leave out the yardsticks (a repeat turn)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.checkout).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    from audio_llama_tpu_torch.ops import _cuda
    from audio_llama_tpu_torch.ops import int4_matmul as i4

    print(f"kernels: {_cuda.build()}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def rb(*s):
        return torch.randint(-128, 128, s, generator=gen, device=dev, dtype=torch.int32).to(
            torch.int8)

    def rs(*s):
        return torch.rand(s, generator=gen, device=dev) * 0.02 + 0.002

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
    if not args.no_prefill:
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
        decode(cs, g, args.decode_rows, not args.no_library, rb, rs, gen)
    print(json.dumps(out), flush=True)
    print(cs.gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
