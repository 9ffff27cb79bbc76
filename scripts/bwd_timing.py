"""Time the causal attention backward's kernels (dq and dk/dv) and their SDPA
yardstick on the card, so that two checkouts can be compared in one call.

Rows 11 and 12 (tri='always') at train A's shape (`chip_smoke.train_bwd_case`:
B 2, T 2048, Hq 24, Hkv 8, hd 128, 2014 real keys) and train B's batch (B 8),
beside the backward of SDPA (is_causal, enable_gqa: dq, dk and dv in one
call); rows 11n and 12n (tri='never') at the sp = 2 hop of train A
(`chip_smoke.ring_hop_case`: B 2, T 1024) beside SDPA's backward with no
mask, with the backend PyTorch chose (`chip_smoke.sdpa_backend`). Each is
timed by CUPTI (`chip_smoke.time_ms`, 20 calls after 3 warm-up calls) and by
CUDA events (`events_ms`), with chip_smoke from the
checkout that holds this script; the kernels are those of the checkout named
by --checkout (default: this one), whose `audio_llama_tpu_torch` is imported
and built in place of this one's. Prints the card's name and power limit,
then one JSON line {"<case> <name>": {"cupti": ms, "events": ms}, ...}.
With --accuracy it first holds dq, dk and dv at each batch (three seeds)
and at the hop against the plain backward: each output's ratio to
chip_smoke's bar (`tol_ratio`, <= 1 passes) and a sha256 prefix of the
outputs' bytes (equal prefixes in two checkouts: the same bits):

    python scripts/bwd_timing.py --checkout <dir> [--accuracy]
"""
import hashlib
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
    ap.add_argument("--batch", type=int, nargs="+", default=[2, 8],
                    help="batch sizes of rows 11 and 12")
    ap.add_argument("--accuracy", action="store_true",
                    help="also each output's bar ratio against the plain backward and its bits")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.checkout).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    from audio_llama_tpu_torch.ops import _cuda
    from audio_llama_tpu_torch.ops import causal_attention as ca

    print(cs.gpu_line(), flush=True)
    print(f"kernels: {_cuda.build()}", flush=True)
    dev = torch.device("cuda", 0)
    out, by = {}, set()

    def timed(label, calls):
        nonlocal by
        for name, fn in calls.items():
            cupti, events = cs.time_ms(fn), cs.events_ms(fn)
            out[f"{label} {name}"] = {"cupti": float(cupti), "events": float(events)}
            if name.startswith("sdpa"):
                out[f"{label} {name}"]["backend"] = cs.sdpa_backend(fn)
            by |= {cupti.by}
        torch.cuda.synchronize()

    bars = ("causal_attention_dq", "causal_attention_dkv", "causal_attention_dkv")

    def accuracy(label, c, tri):
        a = tuple(c[n] for n in "qs k v key_bias l m do d".split())
        got = (ca.causal_attention_dq_cuda(*a, tri=tri), *ca.causal_attention_dkv_cuda(*a, tri=tri))
        want = ca.causal_attention_bwd_plain(*(c[n] for n in "qs k v key_bias o l m do".split()),
                                             tri=tri)
        entry = {n: cs.tol_ratio(g, w, cs.ATOL_ROW_RMS_FRAC[bar], cs.GRAD_RMS_DIMS)
                 for n, g, w, bar in zip(("dq", "dk", "dv"), got, want, bars)}
        h = hashlib.sha256()
        for g in got:
            h.update(g.view(torch.int16).cpu().numpy().tobytes())
        out[f"accuracy {label}"] = {**entry, "bits": h.hexdigest()[:16]}
        torch.cuda.empty_cache()

    if args.accuracy:
        for B in args.batch:
            for seed in (100, 101, 102):
                accuracy(f"B={B} seed={seed}", cs.train_bwd_case(
                    dev, torch.Generator(device=dev).manual_seed(seed), B), "always")

    for B in args.batch:
        c = cs.train_bwd_case(dev, torch.Generator(device=dev).manual_seed(B), B)
        a = tuple(c[n] for n in "qs k v key_bias l m do d".split())
        timed(f"B={B}", {
            "causal_attention_dq": lambda a=a: ca.causal_attention_dq_cuda(*a),
            "causal_attention_dkv": lambda a=a: ca.causal_attention_dkv_cuda(*a),
            "sdpa backward (is_causal, enable_gqa)": cs.sdpa_backward(
                c["qs"], c["k"], c["v"], c["do"], causal=True)})
        del c, a
        torch.cuda.empty_cache()
    lc = cs.full_config().llama
    T = cs.TRAIN_T // 2
    hop = cs.ring_hop_case(dev, torch.Generator(device=dev).manual_seed(12), cs.TRAIN_B, T,
                           lc.num_heads, lc.num_kv_heads, lc.head_dim, pad_from=T * 7 // 8)
    hop["key_bias"] = hop["bias"]
    if args.accuracy:
        accuracy("hop", hop, "never")
    a = tuple(hop[n] for n in "qs k v bias l m do d".split())
    timed("hop", {
        "causal_attention_dq_never": lambda: ca.causal_attention_dq_cuda(*a, tri="never"),
        "causal_attention_dkv_never": lambda: ca.causal_attention_dkv_cuda(*a, tri="never"),
        "sdpa backward (no mask, enable_gqa)": cs.sdpa_backward(
            hop["qs"], hop["k"], hop["v"], hop["do"], causal=False)})
    out["timed_by"] = sorted(by)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
