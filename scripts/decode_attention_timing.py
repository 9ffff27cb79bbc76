"""Time the timeline decode kernels (rows 4, 13-19, 29, 30) beside their
SDPA yardsticks on the card for one checkout's kernels, and run the bf16
main path, the serving pool and the `--decode_impl` arms end to end, so
that two checkouts can be compared in turns in one call.

Kernels, at the decoder's geometry (28 layers, 8 KV heads, 24 query heads,
hd 128, chip_smoke's seeded `db_case` inputs), for each B of --batch and
each S of --slots: the bf16 main path's decode attention (row 4, the
offset a [B] tensor on the device), the packed kernel on a bf16 and an int8
cache (row 19), the single kernel on a bf16 and an int8 cache (rows 29,
30), the normalized db kernel on bf16, int8 and int4 caches (rows 16-18)
and the stats kernel on the same three (rows 13-15, called as a rank that
does not own the fresh row), every call appending at slot S - 24 with the
slots up to it valid, the layer rotating over the 28; each by CUPTI over
56 calls after 3 warm-up calls (`ms`: every device record of a call, the
wrappers' small copies included, as chip_smoke's `time_ms` sums them;
`kernel_ms`: the attention kernel's records alone), beside SDPA over
the same slab (`sdpa_slab`, K/V bf16, dequantized and repeated per query
head ahead of time) and the bytes bound. Then the stats kernels as the sp
serving path's two ranks call them at its last decode step
(chip_smoke's `sp_slots`): rank 0 over its whole slab, rank 1 owning the
fresh row.

End to end (unless --no-paths), chip_smoke's requests (`bf16_request`,
`int4_request(b1=True)`), B 1: on the bf16 tree the auto arm (the main
path: row 4), the decode_kernel arm, and the decode_packed arm on a bf16
and on an int8 KV cache (row 19); on the int4w+kv4 tree the decode_kernel
arm: N_NEW greedy tokens through `generate(attn_impl=...)`, the decode ms
per token, every step's top-2 logit margin (a top-2 a step is captured, so
this run's ms is not chip_smoke's), and one decode token's device time by
kernel group (chip_smoke's `path_profile`: torch.profiler, 9 new tokens
less 1). Then the serving pool on the bf16 tree with a bf16 KV cache (row 4
with one offset a row): four requests of N_NEW greedy tokens, two with
audio, their chains.

The timers, inputs and phases are chip_smoke.py's from the checkout that
holds this script; the package, kernels included, is --checkout's (default:
this one). Prints JSON lines (also to --log) and the card's name and power
limit. --compare reads two logs (no card) and prints whether each greedy
chain equals and, where it parts, the parted row's margins there:

    python scripts/decode_attention_timing.py --checkout <dir> --log <file>
    python scripts/decode_attention_timing.py --compare <parent.log> <change.log>
    python scripts/decode_attention_timing.py --sweep 512 1568 3040 6080

--sweep times only rows 4, 16 and 18 at B 1 at the given slot counts, at
the planner's launch and at other cluster sizes (1-4) and ring depths, and
row 16 with 1, 3 and 8 query heads a KV head. --order (no timing) holds
rows 13-18 at chip_smoke's sp slab to the plain version and the plain
version to itself with its logits correctly rounded, under chip_smoke's
bar: what the logits' f32 summation order alone moves.

    python scripts/decode_attention_timing.py --order
"""
import argparse
import importlib.util
import itertools
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
L, HKV, HQ, HD = 28, 8, 24, 128
ROWS = {  # row -> (kind, cache bits)
    "4 decode_attention_mono": ("mono", 16),
    "19 decode_attention_packed": ("packed", 16),
    "19 decode_attention_quantized_packed": ("packed", 8),
    "29 decode_attention": ("single", 16), "30 decode_attention_quantized": ("single", 8),
    "16 decode_attention_db": ("db", 16), "17 decode_attention_quantized_db": ("db", 8),
    "18 decode_attention_quantized4_db": ("db", 4),
    "13 decode_attention_db_stats": ("stats", 16),
    "14 decode_attention_quantized_db_stats": ("stats", 8),
    "15 decode_attention_quantized4_db_stats": ("stats", 4),
}
AB_NAME = {16: "decode_attention_db", 8: "decode_attention_quantized_db",
           4: "decode_attention_quantized4_db"}


def load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def call(cs, kind, case, bits, li, off, valid, scale):
    """One kernel call on the case's own caches (the append repeats); the
    mono kind takes `off` as its [B] tensor on the device."""
    from audio_llama_tpu_torch.ops import decode_attention_db as db
    from audio_llama_tpu_torch.ops import decode_attention_mono as dm

    if kind == "mono":
        return dm.decode_attention_cuda(case["q"], *case["rows"], *case["caches"], li, off,
                                        valid, scale)
    if kind == "packed":
        return cs.ab_call("decode_attention_packed", case, bits, li, off, valid, scale,
                          copy=False)
    if kind == "single":
        return cs.single_call(case, bits, li, off, valid, scale, copy=False)
    if kind == "db":
        return cs.ab_call(AB_NAME[bits], case, bits, li, off, valid, scale, copy=False)
    fn = {16: db.db_stats_cuda, 8: db.db_stats_q8_cuda, 4: db.db_stats_q4_cuda}[bits]
    return fn(case["q"], *case["rows"], *case["caches"], *(case["scales"] or []),
              *(case["fresh"] or []), li, off, valid, scale)


def timed(cs, fn, iters=56):
    """-> (ms: every device record of a call, kernel_ms: the attention
    kernel's alone), by CUPTI over `iters` calls after 3 warm-up calls."""
    for _ in range(3):
        fn()

    def many():
        for _ in range(iters):
            fn()

    try:
        _, by_name, _ = cs.traced(many, calls=iters)
    except AssertionError as err:  # CUPTI lost records: CUDA events, no kernel_ms
        cs.log(f"timed: {err}; by CUDA events instead")
        return float(cs.events_ms(fn, iters=iters, warmup=0)), None
    kernel = sum(ms for name, ms in by_name.items()  # (the first designs' names too)
                 if any(k in name for k in ("single_kernel", "db_kernel", "::decode_kernel<",
                                            "packed_")))
    return sum(by_name.values()) / iters, kernel / iters


def sweep(cs, log, gen, slots):
    """Rows 16 and 18 (the normalized db kernel, bf16 and int4 caches) and
    row 4 (the mono mode) at B 1 for each S, at the planner's launch and at
    forced cluster sizes C and ring depths: where a call's time goes (per
    ring stage a block, per launch)."""
    import torch

    from audio_llama_tpu_torch.ops import decode_attention_db as db
    from audio_llama_tpu_torch.ops import decode_attention_mono as dm
    from audio_llama_tpu_torch.ops import decode_timeline as dtl

    dev = torch.device("cuda", 0)
    scale = HD ** -0.5
    for (kind, bits, mod, name), S in itertools.product(
            (("db", 16, db, AB_NAME[16]), ("db", 4, db, AB_NAME[4]),
             ("mono", 16, dm, "decode_attention_mono")), slots):
        planner = mod.timeline_plan
        fmt = cs.TIMELINE_FMT[bits]
        base = dtl.timeline_plan(1, HKV, S, HQ // HKV, HD, fmt)
        case = cs.db_case(dev, gen, bits, 1, S, L, HKV, HQ, HD)
        valid = (torch.arange(S, device=dev)[None, :] <= S - 24).to(torch.int32)
        off = S - 24 if kind == "db" else torch.tensor([S - 24], dtype=torch.int32, device=dev)
        for C, stages in [(base.C, base.stages)] + [(c, base.stages) for c in (1, 2, 4)] \
                + [(base.C, r) for r in (2, 4, 8)]:
            if C > S // 32:
                continue
            n = dtl.range_slots(S, C)
            smem = dtl.block_smem(fmt, HQ // HKV, HD, n, stages)
            if smem > dtl.SMEM_MAX:
                continue
            mod.timeline_plan = lambda *a, **k: dtl.TimelinePlan(C, stages, n, smem, HKV)
            turn = itertools.count()
            try:
                ms, kernel_ms = timed(cs, lambda: call(cs, kind, case, bits, next(turn) % L,
                                                       off, valid, scale))
            finally:
                mod.timeline_plan = planner
            log(json.dumps({f"sweep {name} B=1 S={S} C={C} stages={stages}": dict(
                ms=ms, kernel_ms=kernel_ms, stages_a_block=2 * -(-n // dtl.stage_rows(fmt, HD)), planner=(C, stages) ==
                (base.C, base.stages))}))
        del case
        torch.cuda.empty_cache()
    # the query heads a KV head serves (the work a row, not its bytes)
    for G, S in itertools.product((1, 3, 8), slots):
        case = cs.db_case(dev, gen, 16, 1, S, L, HKV, HKV * G, HD)
        valid = (torch.arange(S, device=dev)[None, :] <= S - 24).to(torch.int32)
        turn = itertools.count()
        ms, kernel_ms = timed(cs, lambda: call(cs, "db", case, 16, next(turn) % L, S - 24,
                                               valid, scale))
        log(json.dumps({f"sweep decode_attention_db B=1 S={S} G={G}": dict(
            ms=ms, kernel_ms=kernel_ms)}))
        del case
        torch.cuda.empty_cache()


def order(cs, log, gen):
    """Rows 13-18 at chip_smoke's db_kernel_checks shapes (the sp path's
    local slab, the owner rank's call, B 1 and 4): the kernel against the
    plain version, and the plain version against itself with its logits
    correctly rounded (each q . k summed in f64, rounded once to f32), under
    chip_smoke's bar: how far the logits' f32 summation order alone moves
    each output."""
    import torch

    dev = torch.device("cuda", 0)
    S, prefix = cs.sp_slots(cs.full_config())
    own = prefix + cs.N_NEW - 2 - S
    scale, li = HD ** -0.5, 5
    einsum = torch.einsum

    def f64_logits(eq, *ops):  # the plain versions' logits, correctly rounded
        if eq == "bhgd,bhsd->bhgs":
            return einsum(eq, *(t.double() for t in ops)).float()
        return einsum(eq, *ops)

    for row, (kind, bits) in ROWS.items():
        if kind not in ("db", "stats"):
            continue
        frac = cs.ATOL_ROW_RMS_FRAC["decode_attention_db_stats" if kind == "stats"
                                    else AB_NAME[bits]]
        for B in (1, 4):
            case = cs.db_case(dev, gen, bits, B, S, L, HKV, HQ, HD)
            valid = (torch.arange(S, device=dev)[None, :] <= own).to(torch.int32).repeat(B, 1)

            def out(cuda):
                if kind == "stats":
                    return cs.db_call(case, bits, li, own, valid, scale, cuda=cuda)[2]
                return cs.ab_call(AB_NAME[bits], case, bits, li, own, valid, scale,
                                  cuda=cuda)[0]

            got, want = out(True), out(False)
            torch.einsum = f64_logits
            try:
                exact = out(False)
            finally:
                torch.einsum = einsum
            log(json.dumps({f"order row {row} B={B} S={S}": dict(
                kernel_vs_plain=cs.tol_ratio(got, want, frac),
                plain_vs_f64_logits=cs.tol_ratio(want, exact, frac),
                kernel_vs_f64_logits=cs.tol_ratio(got, exact, frac))}))
            del case
            torch.cuda.empty_cache()


def row_bytes(bits: int) -> int:
    return {16: 4 * HD, 8: 2 * HD + 8, 4: HD + 8}[bits]


def kernels(cs, log, batches, slots, gen):
    import torch

    dev = torch.device("cuda", 0)
    scale = HD ** -0.5
    for B, S in itertools.product(batches, slots):
        off = S - 24
        valid = (torch.arange(S, device=dev)[None, :] <= off).to(torch.int32).repeat(B, 1)
        n_valid = int(valid[0].sum())
        offs = torch.full((B,), off, dtype=torch.int32, device=dev)  # mono: on the device
        for row, (kind, bits) in ROWS.items():
            case = cs.db_case(dev, gen, bits, B, S, L, HKV, HQ, HD)
            turn = itertools.count()
            at = S + 16 if kind == "stats" else offs if kind == "mono" else off  # stats: a
            # rank that does not own the fresh row
            nbytes = B * (HKV * n_valid * row_bytes(bits) + 2.0 * HQ * HD * 2 + 4.0 * S
                          + HKV * row_bytes(bits))
            bms, by = cs.bound(4.0 * B * HQ * n_valid * HD, nbytes)
            ms, kernel_ms = timed(cs, lambda: call(cs, kind, case, bits, next(turn) % L, at,
                                                   valid, scale))
            entry = dict(ms=ms, kernel_ms=kernel_ms,
                         library_ms=float(cs.time_ms(cs.sdpa_slab(case, bits, valid, scale,
                                                                  turn), iters=56)),
                         bound_ms=bms, bound_by=by)
            log(json.dumps({f"row {row} B={B} S={S}": entry}))
            del case
            torch.cuda.empty_cache()


def sp_ranks(cs, log, gen):
    """The stats kernels as sp = 2's ranks call them at the last decode step."""
    import torch

    dev = torch.device("cuda", 0)
    S, prefix = cs.sp_slots(cs.full_config())
    glob = prefix + cs.N_NEW - 2
    scale = HD ** -0.5
    kpos = torch.arange(S, device=dev)[None, :]
    for row, (kind, bits) in ROWS.items():
        if kind != "stats":
            continue
        case = cs.db_case(dev, gen, bits, 1, S, L, HKV, HQ, HD)
        for rank, off, valid in ((0, glob, torch.ones((1, S), dtype=torch.int32, device=dev)),
                                 (1, glob - S, (kpos <= glob - S).to(torch.int32))):
            turn = itertools.count()
            ms, kernel_ms = timed(cs, lambda: call(cs, kind, case, bits, next(turn) % L, off,
                                                   valid, scale))
            log(json.dumps({f"sp rank {rank} row {row} S={S}": dict(
                ms=ms, kernel_ms=kernel_ms, valid_slots=int(valid.sum()))}))
        del case
        torch.cuda.empty_cache()


def paths(cs, log):
    """The bf16 tree's auto, decode_kernel and decode_packed (bf16 and int8
    KV) arms and its serving pool with a bf16 KV cache; the int4w+kv4
    tree's decode_kernel arm; B 1."""
    import torch

    from audio_llama_tpu_torch.inference.generate import generate
    from audio_llama_tpu_torch.ops import sampling

    dev = torch.device("cuda", 0)
    steps = []
    sample = sampling.sample_token

    def recording(logits, *a, **kw):
        top = logits.float().topk(2, dim=-1).values
        steps.append((top[:, 0] - top[:, 1]).tolist())
        return sample(logits, *a, **kw)

    def arm(label, model, kv, impl):
        cfg, frozen, trainable, ids, mask, audio = model
        kw = dict(eos_id=cs.EOS, pad_id=0, audio_start_id=cs.AUDIO_START,
                  audio_end_id=cs.AUDIO_END, compute_dtype=torch.bfloat16, device=dev,
                  kv_quant=kv, greedy=True, attn_impl=impl)

        def run(n):
            return generate(frozen, trainable, cfg, ids, mask, audio, None, max_new_tokens=n,
                            **kw)

        run(2)
        first_ms = min(cs.synced_ms(lambda: run(1)) for _ in range(2))
        result = {}
        total_ms = cs.synced_ms(lambda: result.setdefault("out", run(cs.N_NEW)))
        sampling.sample_token = recording
        steps.clear()
        again = run(cs.N_NEW).tokens
        sampling.sample_token = sample
        toks = result["out"].tokens
        log(json.dumps({"chain": dict(
            name=label, tokens=toks.tolist(), top2_margin_per_step=steps[-cs.N_NEW:],
            repeat_equal=bool(torch.equal(again, toks)),
            decode_ms_per_token=(total_ms - first_ms) / (cs.N_NEW - 1))}))
        cs.path_profile(run, label)

    cfg, frozen, trainable, ids, mask, audio, _ = cs.bf16_request(dev)
    bf16 = (cfg, frozen, trainable, ids, mask, audio)
    for label, kv, impl in (("auto bf16 B=1", False, "auto"),
                            ("decode_kernel bf16 B=1", False, "decode_kernel"),
                            ("decode_packed bf16 B=1", False, "decode_packed"),
                            ("decode_packed bf16w+kv8 B=1", True, "decode_packed")):
        arm(label, bf16, kv, impl)
    pool(cs, log, bf16)
    del bf16, frozen, trainable
    torch.cuda.empty_cache()
    cfg, frozen, trainable, ids, mask, audio, _, _ = cs.int4_request(dev, b1=True)
    arm("decode_kernel int4w+kv4 B=1", (cfg, frozen, trainable, ids, mask, audio), 4,
        "decode_kernel")
    del frozen, trainable
    torch.cuda.empty_cache()


def pool(cs, log, model):
    """The serving pool (4 rows, bf16 KV: row 4 with one offset a row) on the
    bf16 tree: four requests of N_NEW greedy tokens (two with seeded 30 s
    audio, prompts of 24, 16, 20 and 12 tokens), each one's chain."""
    import numpy as np
    import torch

    from audio_llama_tpu_torch.inference.serving import ServingEngine

    cfg, frozen, trainable = model[:3]
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(4)
    eng = ServingEngine(frozen, trainable, cfg, rows=4,
                        max_len=cs._rounded_len(cfg.audio_seq_len + 2 + 64 + cs.N_NEW),
                        prefill_buckets=(32,), chunk_steps=8, kv_quant=False,
                        compute_dtype=torch.bfloat16, greedy=True, eos_id=-1, pad_id=0,
                        audio_start_id=cs.AUDIO_START, audio_end_id=cs.AUDIO_END, device=dev)
    reqs = [(rng.integers(0, cfg.llama.vocab_size, (n,)).astype(np.int32),
             (rng.normal(size=cfg.mel.max_samples) * 0.1).astype(np.float32) if a else None)
            for n, a in ((24, True), (16, False), (20, True), (12, False))]
    with cs.SamplerTrace() as trace:
        rids = [eng.submit(i, audio_features=a, max_new_tokens=cs.N_NEW) for i, a in reqs]
        out = eng.run(max_chunks=64)
    # request n's token 0 from its prefill, token t from decode step t - 1's
    # row n, when the four prefills come first (one admission, rows in order)
    shapes = [lg.shape[0] for lg in trace.logits]
    in_order = shapes[:len(reqs)] == [1] * len(reqs) and 1 not in shapes[len(reqs):]
    top = [lg.topk(2, dim=-1).values for lg in trace.logits]
    margins = [(t[:, 0] - t[:, 1]).tolist() for t in top]
    for n, rid in enumerate(rids):
        rows = [[margins[n][0]]] + [[m[n]] for m in margins[len(reqs):]] if in_order else []
        log(json.dumps({"chain": dict(name=f"pool bf16 KV request {n}", tokens=[out[rid]],
                                      top2_margin_per_step=rows, repeat_equal=None,
                                      decode_ms_per_token=None)}))
    del eng
    torch.cuda.empty_cache()


def compare(first: str, second: str) -> int:
    dp = load(ROOT / "scripts" / "int4_decode_paths.py", "int4_decode_paths")

    def read(path):
        chains, margins, times = {}, {}, {}
        for line in Path(path).read_text().splitlines():
            if line.startswith("{"):
                d = json.loads(line)
                if "chain" in d:
                    c = d["chain"]
                    chains[c["name"]] = c["tokens"]
                    margins[c["name"]] = c["top2_margin_per_step"]
                    times[c["name"]] = c["decode_ms_per_token"]
        return {"chains": chains, "margins": margins, "decode": times}

    a, b = read(first), read(second)
    result = {}
    for n in sorted(set(a["chains"]) | set(b["chains"])):
        if n not in a["chains"] or n not in b["chains"]:
            result[n] = "missing"
            continue
        at = dp.parting(a["chains"][n], b["chains"][n])
        result[n] = "equal" if at is None else dp.parted(n, at, a, b)
    print(json.dumps({"chains": result, "first": a["decode"], "second": b["decode"]}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkout", default=str(ROOT), help="the checkout whose kernels run")
    ap.add_argument("--log", help="the run's log file")
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 4])
    ap.add_argument("--slots", type=int, nargs="+", default=[1568, 3040])
    ap.add_argument("--no-paths", action="store_true", help="skip the end-to-end paths")
    ap.add_argument("--sweep", type=int, nargs="*", metavar="S",
                    help="only time rows 16 and 18 at B 1 over cluster sizes and ring depths "
                         "at these slot counts")
    ap.add_argument("--order", action="store_true",
                    help="only the logits' summation order against chip_smoke's bar, rows 13-18")
    ap.add_argument("--compare", nargs=2, metavar=("FIRST", "SECOND"),
                    help="compare two runs' greedy chains")
    args = ap.parse_args(argv)
    if args.compare:
        return compare(*args.compare)
    sys.path.insert(0, str(Path(args.checkout).resolve()))
    cs = load(ROOT / "chip_smoke.py", "chip_smoke")

    import torch

    from audio_llama_tpu_torch.ops import _cuda

    out = open(args.log, "w") if args.log else None

    def log(msg: str) -> None:
        print(msg, flush=True)
        if out:
            out.write(msg + "\n")
            out.flush()

    cs.log = log  # chip_smoke's phases log through its module global
    # the first designs' kernel names (a parent checkout's rows 4 and 19)
    cs.KERNEL_GROUPS = (("::decode_kernel<", "decode_attention kernel"),
                        ("packed_", "decode_attention_packed kernel")) + cs.KERNEL_GROUPS
    log(f"kernels: {_cuda.build()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.sweep or args.order:
        if args.sweep:
            sweep(cs, log, gen, args.sweep)
        if args.order:
            order(cs, log, gen)
        log(cs.gpu_line())
        return 0
    kernels(cs, log, args.batch, args.slots, gen)
    sp_ranks(cs, log, gen)
    if not args.no_paths:
        paths(cs, log)
    log(cs.gpu_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
