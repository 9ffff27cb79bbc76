"""HTTP serving front end over the continuous-batching engine.

Counterpart of `audio_llama_tpu/inference/server.py`: a stdlib-only HTTP
server whose handlers feed the fixed-row decode pool
(`inference/serving/`), so concurrent requests batch onto one KV cache on
the card.

Threads: exactly one thread touches the device.
- HTTP handler threads (ThreadingHTTPServer) tokenize, read audio files on
  the host (numpy), stage the request and wait on its event. They never
  call into PyTorch.
- One engine thread (`EngineRunner`) owns the ServingEngine: it submits the
  staged requests, registers prefixes, steps decode chunks and fulfils the
  futures as rows retire.

Endpoints (JSON in and out):
  POST /v1/generate  {"prompt": str} or {"prompt_ids": [int]}, optional
                     "audio_path" (a server-visible file), "max_new_tokens"
                     (default 64), "prefix_id" (a /v1/prefix handle: the
                     prompt is then the suffix), per-request sampling
                     overrides "temperature" > 0, "top_p" in (0, 1],
                     "top_k" >= 0, "greedy" (bool), and "stream" (bool)
                     -> {"tokens", "text"?, "n_tokens"}; 400 on bad input,
                     429 when the queue is full, 503 on shutdown, 504 past
                     the request timeout. stream=true: chunked NDJSON, one
                     {"tokens": [...]} per decode chunk, then {"done": true,
                     "n_tokens", "text"?} or {"error"}.
  POST /v1/prefix    {"prompt" | "prompt_ids", "audio_path"?} -> registers a
                     shared prompt prefix (its KV computed once) ->
                     {"prefix_id"}
  GET  /healthz      -> {"ok", "rows", "live", "queued", "errors"}
  GET  /v1/stats     -> lifetime counters (requests, tokens, chunks, uptime)

    python -m audio_llama_tpu_torch.inference.server --platform cpu \\
        --toy_model --tokenizer byte --port 0 --rows 4 --greedy

Without `--platform cpu` the server runs on the card and raises when there
is none. Not ported, and refused as the port's inference CLI refuses them:
`--llama_path` / `--whisper_path` (models/hf_loader.py, ROADMAP queue 1
item 4), `--draft_llama_path` and `--dp` / `--tp` > 1 (speculative serving
and the dp/tp pool, ROADMAP queue 1).
"""

from __future__ import annotations

import argparse
import json
import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np

logger = logging.getLogger(__name__)


@dataclass
class _Future:
    event: threading.Event = field(default_factory=threading.Event)
    tokens: Optional[List[int]] = None
    error: Optional[str] = None
    pid: Optional[int] = None  # prefix-registration result
    # streaming: the engine thread puts per-chunk token deltas (List[int])
    # here as rows decode; None terminates the stream (then read
    # tokens/error for the final state). n_streamed tracks delivery.
    stream_q: Optional["queue.SimpleQueue"] = None
    n_streamed: int = 0

    def _emit(self, item):
        if self.stream_q is not None:
            self.stream_q.put(item)


class EngineRunner:
    """Thread-safe facade over ServingEngine: handler threads stage
    requests; a single loop thread owns every engine (device) call."""

    def __init__(self, engine, poll_interval: float = 0.05,
                 max_queue: int = 256):
        self.engine = engine
        self._poll = poll_interval
        self.max_queue = max_queue
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # (future, ids, feats, max_new, pfx, sampling-overrides)
        self._staging: List[tuple] = []
        self._prefix_reqs: List[tuple] = []  # (future, ids, feats)
        self._futures: Dict[int, _Future] = {}  # rid -> future
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        # lifetime counters (read by /v1/stats)
        self.started_at = time.time()
        self.n_requests = 0
        self.n_completed = 0
        self.n_tokens = 0
        self.n_chunks = 0
        self.n_errors = 0

    # ---- handler-thread side ----

    def submit(
        self, ids: np.ndarray, feats, max_new: int, stream: bool = False,
        prefix: Optional[int] = None,
        sampling: Optional[dict] = None,
    ) -> _Future:
        """sampling: per-request overrides ({temperature, top_p, top_k,
        greedy} subset) forwarded to engine.submit (per-row tensors of the
        decode chunk)."""
        fut = _Future()
        if stream:
            fut.stream_q = queue.SimpleQueue()
        with self._cv:
            if self._stop:
                fut.error = "server shutting down"
                fut.event.set()
                fut._emit(None)
                return fut
            # validate HERE (handler thread): a bad handle raising inside
            # the loop's staged batch would fail unrelated requests
            if prefix is not None and prefix not in self.engine._prefixes:
                fut.error = f"unknown prefix_id {prefix}"
                fut.event.set()
                fut._emit(None)
                return fut
            # back-pressure: bound host-side memory under overload
            if (
                len(self._staging) + len(self.engine._queue)
                >= self.max_queue
            ):
                fut.error = "server overloaded: queue full"
                fut.event.set()
                fut._emit(None)
                return fut
            self._staging.append(
                (fut, ids, feats, max_new, prefix, sampling)
            )
            self.n_requests += 1
            self._cv.notify()
        return fut

    def register_prefix(
        self, ids: np.ndarray, feats, timeout: float = 600.0
    ) -> _Future:
        """Stage a prefix registration; the engine thread performs it
        (device prefill + possible compile) between chunks. Blocks until
        done or `timeout` (seconds); read .pid / .error off the returned
        future."""
        fut = _Future()
        with self._cv:
            if self._stop:
                fut.error = "server shutting down"
                fut.event.set()
                return fut
            self._prefix_reqs.append((fut, ids, feats))
            self._cv.notify()
        fut.event.wait(timeout)
        if not fut.event.is_set():
            fut.error = "prefix registration timed out"
        return fut

    # ---- engine-thread side ----

    def start(self):
        self._thread = threading.Thread(
            target=self._loop, name="engine-loop", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, timeout: float = 30.0):
        with self._cv:
            self._stop = True
            self._cv.notify()
        if self._thread is not None:
            self._thread.join(timeout)
        # fail any request still in flight
        with self._cv:
            leftovers = [f for f, *_ in self._staging]
            leftovers += [f for f, *_ in self._prefix_reqs]
            leftovers += list(self._futures.values())
            self._staging = []
            self._prefix_reqs = []
            self._futures = {}
        for f in leftovers:
            if not f.event.is_set():
                f.error = "server shutting down"
                f.event.set()
                f._emit(None)

    def _has_live_rows(self) -> bool:
        return any(not r.free for r in self.engine._rows)

    def _loop(self):
        eng = self.engine
        while True:
            with self._cv:
                while (
                    not self._stop
                    and not self._staging
                    and not self._prefix_reqs
                    and not self._has_live_rows()
                    and not self.engine._queue  # admissions still pending
                ):
                    self._cv.wait(self._poll)
                if self._stop:
                    return
                staged, self._staging = self._staging, []
                preqs, self._prefix_reqs = self._prefix_reqs, []
            # prefix registrations touch no pool state: failures report to
            # their own future only
            for fut, ids, feats in preqs:
                try:
                    fut.pid = eng.register_prefix(ids, audio_features=feats)
                except Exception as e:
                    logger.exception("prefix registration failed")
                    fut.error = f"prefix registration failed: {e}"
                fut.event.set()
            try:
                for fut, ids, feats, max_new, pfx, smp in staged:
                    rid = eng.submit(
                        ids, audio_features=feats, max_new_tokens=max_new,
                        prefix=pfx, **(smp or {}),
                    )
                    self._futures[rid] = fut
                eng.step_chunk()
                self.n_chunks += 1
            except Exception as e:  # engine bug/device error: fail loudly
                logger.exception("engine loop error")
                self.n_errors += 1
                for fut, *_ in staged:
                    if not fut.event.is_set():
                        fut.error = f"engine error: {e}"
                        fut.event.set()
                        fut._emit(None)
                for fut in self._futures.values():
                    if not fut.event.is_set():
                        fut.error = f"engine error: {e}"
                        fut.event.set()
                        fut._emit(None)
                self._futures = {}
                # the failed step may leave the pool state half written and
                # host rows live: rebuild both, or every retry spins on a
                # dead pool
                try:
                    eng.reset()
                except Exception:
                    logger.exception("engine reset after error failed")
                time.sleep(min(2.0 ** min(self.n_errors, 4), 10.0))
                continue
            self._stream_live()
            self._deliver_finished()

    def _stream_live(self):
        """Push per-chunk token deltas of still-decoding rows to their
        streaming futures (rows that retired this chunk are handled by
        _deliver_finished, which flushes the final delta)."""
        for row in self.engine._rows:
            if row.free:
                continue
            fut = self._futures.get(row.rid)
            if fut is None or fut.stream_q is None:
                continue
            delta = row.emitted[fut.n_streamed:]
            if delta:
                fut.n_streamed += len(delta)
                fut._emit(list(delta))

    def _deliver_finished(self):
        # pop so a long-running server's result map stays bounded
        for rid in list(self.engine._results.keys()):
            toks = self.engine._results.pop(rid)
            fut = self._futures.pop(rid, None)
            if fut is None:
                continue
            if toks:
                fut.tokens = toks
                self.n_completed += 1
                self.n_tokens += len(toks)
                delta = toks[fut.n_streamed:]
                if delta:
                    fut.n_streamed += len(delta)
                    fut._emit(list(delta))
            else:
                # engine admission rejected it (cannot fit the pool)
                fut.error = "request rejected: does not fit the pool"
            fut.event.set()
            fut._emit(None)

    # ---- introspection ----

    def health(self) -> dict:
        return {
            "ok": self._thread is not None and self._thread.is_alive(),
            "rows": self.engine.rows,
            "live": sum(not r.free for r in self.engine._rows),
            "queued": len(self.engine._queue) + len(self._staging),
            "errors": self.n_errors,
        }

    def stats(self) -> dict:
        out = {
            "uptime_s": round(time.time() - self.started_at, 1),
            "requests": self.n_requests,
            "completed": self.n_completed,
            "tokens": self.n_tokens,
            "chunks": self.n_chunks,
            "rows": self.engine.rows,
            "prefill_buckets": list(self.engine.buckets),
            "chunk_steps": self.engine.chunk_steps,
            "kv_quant": self.engine.kv_quant,
            "prefixes": len(self.engine._prefixes),
            "prefix_admits": self.engine.prefix_admits,
            "decode_chunks": self.engine.decode_chunks,
        }
        return out


class AudioLLMServer:
    """Binds an EngineRunner + tokenizer/featurizer to an HTTP port."""

    def __init__(
        self,
        runner: EngineRunner,
        cfg,
        tokenizer=None,
        host: str = "127.0.0.1",
        port: int = 8000,
        request_timeout: float = 600.0,
    ):
        self.runner = runner
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.request_timeout = request_timeout
        handler = self._make_handler()
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.httpd.daemon_threads = True
        self._serve_thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self):
        self.runner.start()
        self._serve_thread = threading.Thread(
            target=self.httpd.serve_forever, name="http", daemon=True
        )
        self._serve_thread.start()
        return self

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._serve_thread is not None:
            self._serve_thread.join(10)
        self.runner.stop()

    # ---- request plumbing ----

    @staticmethod
    def _sampling_overrides(body: dict) -> Optional[dict]:
        """Validated per-request sampling overrides from a request body
        (None if the request doesn't override anything): the server's CLI
        sampling flags are only engine DEFAULTS."""
        out = {}
        if "temperature" in body:
            t = float(body["temperature"])
            if not t > 0:
                raise ValueError("temperature must be > 0")
            out["temperature"] = t
        if "top_p" in body:
            p = float(body["top_p"])
            if not 0 < p <= 1:
                raise ValueError("top_p must be in (0, 1]")
            out["top_p"] = p
        if "top_k" in body:
            k = int(body["top_k"])
            if k < 0:
                raise ValueError("top_k must be >= 0")
            out["top_k"] = k
        if "greedy" in body:
            g = body["greedy"]
            if not isinstance(g, bool):
                raise ValueError("greedy must be a JSON boolean")
            out["greedy"] = g
        return out or None

    def _prepare(self, body: dict):
        """(ids, feats, max_new, prefix, sampling) from a request body;
        raises ValueError on client errors."""
        max_new = int(body.get("max_new_tokens", 64))
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        sampling = self._sampling_overrides(body)
        prefix = body.get("prefix_id")
        if prefix is not None:
            prefix = int(prefix)
        audio_path = body.get("audio_path")
        feats = None
        if audio_path is not None:
            if prefix is not None:
                raise ValueError(
                    "audio_path with prefix_id: register the audio as "
                    "part of the prefix instead"
                )
            from .cli import process_audio

            feats = process_audio(str(audio_path), self.cfg.mel)[0]  # [S], host numpy

        if "prompt_ids" in body:
            ids = np.asarray(body["prompt_ids"], np.int32).reshape(-1)
            if ids.size == 0:
                raise ValueError("prompt_ids is empty")
            return ids, feats, max_new, prefix, sampling

        prompt = body.get("prompt")
        if prompt is None:
            raise ValueError("need 'prompt' or 'prompt_ids'")
        if self.tokenizer is None:
            raise ValueError(
                "server has no tokenizer; send 'prompt_ids' instead"
            )
        if (
            feats is not None
            and self.cfg.splice_mode == "inplace"
            and self.cfg.audio_start_token not in prompt
        ):
            # mirror the training-side placeholder insertion (cli.py)
            prompt = (
                f"{self.cfg.audio_start_token}{self.cfg.audio_end_token} "
                f"{prompt}"
            )
        ids, mask = self.tokenizer.encode(prompt)
        ids = np.asarray(ids, np.int32)[np.asarray(mask, bool)]
        return ids, feats, max_new, prefix, sampling

    def _register_prefix(self, body: dict) -> tuple:
        """POST /v1/prefix -> (status, payload with prefix_id)."""
        try:
            ids, feats, _max_new, pfx, smp = self._prepare(body)
            if pfx is not None:
                raise ValueError("prefix_id is not valid when registering")
            if smp is not None:
                raise ValueError(
                    "sampling params are not valid when registering a "
                    "prefix (set them on /v1/generate requests)"
                )
        except (ValueError, TypeError, KeyError, OSError) as e:
            return 400, {"error": str(e)}
        fut = self.runner.register_prefix(
            ids, feats, timeout=self.request_timeout
        )
        if fut.error is not None:
            code = 503 if "shutting down" in fut.error else 400
            return code, {"error": fut.error}
        return 200, {"prefix_id": fut.pid}

    def _start_stream(self, body: dict):
        """-> (400, payload) on bad input, else (200, _Future) whose
        stream_q yields per-chunk token deltas then a None terminator."""
        try:
            ids, feats, max_new, pfx, smp = self._prepare(body)
        except (ValueError, TypeError, KeyError, OSError) as e:
            # OSError: unreadable audio_path; Type/KeyError: malformed
            # fields — all client errors, never a dropped socket
            return 400, {"error": str(e)}
        return 200, self.runner.submit(
            ids, feats, max_new, stream=True, prefix=pfx, sampling=smp
        )

    def _generate(self, body: dict) -> tuple:
        """-> (status, payload)"""
        try:
            ids, feats, max_new, pfx, smp = self._prepare(body)
        except (ValueError, TypeError, KeyError, OSError) as e:
            return 400, {"error": str(e)}
        fut = self.runner.submit(ids, feats, max_new, prefix=pfx,
                                 sampling=smp)
        if not fut.event.wait(self.request_timeout):
            return 504, {"error": "generation timed out"}
        if fut.error is not None:
            if "shutting down" in fut.error:
                code = 503
            elif "overloaded" in fut.error:
                code = 429
            else:
                code = 400
            return code, {"error": fut.error}
        out = {
            "tokens": [int(t) for t in fut.tokens],
            "n_tokens": len(fut.tokens),
        }
        if self.tokenizer is not None:
            out["text"] = self.tokenizer.decode(
                np.asarray(fut.tokens, np.int32), skip_special_tokens=True
            )
        return 200, out

    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # route to logging, not stderr
                logger.debug("%s - %s", self.address_string(), fmt % args)

            def _send(self, code: int, payload: dict):
                data = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            # -- streaming (chunked transfer encoding, NDJSON events) --

            def _chunk(self, payload: dict):
                data = json.dumps(payload).encode() + b"\n"
                self.wfile.write(
                    f"{len(data):x}\r\n".encode() + data + b"\r\n"
                )

            def _stream(self, fut):
                """Relay per-chunk token deltas as NDJSON lines:
                {"tokens": [...]} per decode chunk, then a final
                {"done": true, "n_tokens": N, "text"?: ...} or
                {"error": ...}; token ids stream incrementally, text is
                decoded once at the end (partial BPE byte sequences
                don't round-trip through str)."""
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                deadline = time.time() + server.request_timeout
                try:
                    while True:
                        try:
                            item = fut.stream_q.get(
                                timeout=max(0.0, deadline - time.time())
                            )
                        except queue.Empty:
                            self._chunk({"error": "generation timed out"})
                            break
                        if item is None:
                            if fut.error is not None:
                                self._chunk({"error": fut.error})
                            else:
                                out = {
                                    "done": True,
                                    "n_tokens": len(fut.tokens),
                                }
                                if server.tokenizer is not None:
                                    out["text"] = server.tokenizer.decode(
                                        np.asarray(fut.tokens, np.int32),
                                        skip_special_tokens=True,
                                    )
                                self._chunk(out)
                            break
                        self._chunk({"tokens": item})
                finally:
                    self.wfile.write(b"0\r\n\r\n")

            def do_GET(self):
                if self.path == "/healthz":
                    h = server.runner.health()
                    self._send(200 if h["ok"] else 503, h)
                elif self.path == "/v1/stats":
                    self._send(200, server.runner.stats())
                else:
                    self._send(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                if self.path not in ("/v1/generate", "/v1/prefix"):
                    self._send(404, {"error": f"no route {self.path}"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n) or b"{}")
                    if not isinstance(body, dict):
                        raise ValueError("body must be a JSON object")
                except (ValueError, json.JSONDecodeError) as e:
                    self._send(400, {"error": f"bad request body: {e}"})
                    return
                if self.path == "/v1/prefix":
                    code, payload = server._register_prefix(body)
                    self._send(code, payload)
                    return
                if body.get("stream"):
                    code, res = server._start_stream(body)
                    if code != 200:
                        self._send(code, res)
                    elif res.error is not None:  # rejected before start
                        code = 503 if "shutting down" in res.error else 429
                        self._send(code, {"error": res.error})
                    else:
                        self._stream(res)
                    return
                code, payload = server._generate(body)
                self._send(code, payload)

        return Handler


def build_server(args) -> AudioLLMServer:
    """CLI plumbing: load the model (the port CLI's loader), quantize it per
    the flags, build the engine, its runner and the HTTP front end."""
    import torch

    from .cli import load_audio_llm
    from .serving import ServingEngine
    from .serving.engine import NOT_PORTED

    if args.draft_llama_path:
        raise NotImplementedError(f"--draft_llama_path: speculative serving {NOT_PORTED}")
    if args.dp > 1 or args.tp > 1:
        raise NotImplementedError(f"--dp {args.dp} --tp {args.tp}: the dp/tp serving pool "
                                  f"{NOT_PORTED}")
    device = "cpu" if args.platform == "cpu" else None
    cfg, frozen, trainable, tk = load_audio_llm(
        args.checkpoint_path, llama_path=args.llama_path, whisper_path=args.whisper_path,
        tokenizer=args.tokenizer, toy_model=args.toy_model, seed=args.seed, device=device)
    if args.int4_decoder or args.int8_decoder:
        from ..bridge import ParamTree
        from ..models import llama_int4, llama_int8

        frozen = ParamTree(dict(frozen.items()))
        frozen["llama"] = (llama_int4.quantize_llama_int4(frozen["llama"]) if args.int4_decoder
                           else llama_int8.quantize_llama(frozen["llama"]))
    engine = ServingEngine(
        frozen, trainable, cfg, rows=args.rows, max_len=args.max_len,
        prefill_buckets=tuple(args.prefill_buckets), chunk_steps=args.chunk_steps,
        kv_quant=args.kv_bits if args.kv_quant else False,
        compute_dtype=torch.float32 if args.platform == "cpu" else torch.bfloat16,
        greedy=args.greedy, temperature=args.temperature, top_p=args.top_p,
        top_k=args.top_k, eos_id=tk.eos_id, pad_id=tk.pad_id,
        audio_start_id=tk.token_to_id(cfg.audio_start_token),
        audio_end_id=tk.token_to_id(cfg.audio_end_token), seed=args.seed,
        auto_prefix=args.auto_prefix, prefill_chunk_tokens=args.prefill_chunk_tokens,
        admit_batch=args.admit_batch, device=device)
    runner = EngineRunner(engine, max_queue=args.max_queue)
    return AudioLLMServer(runner, cfg, tokenizer=tk, host=args.host, port=args.port,
                          request_timeout=args.request_timeout)


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="AudioLLM HTTP serving (continuous batching, PyTorch/CUDA port)")
    p.add_argument("--checkpoint_path", type=str, default=None)
    p.add_argument("--llama_path", type=str, default=None)
    p.add_argument("--whisper_path", type=str, default=None)
    p.add_argument("--tokenizer", type=str, default=None)
    p.add_argument("--toy_model", action="store_true")
    p.add_argument("--platform", type=str, default=None,
                   help="'cpu' runs the plain PyTorch versions on the host; the default is "
                        "the CUDA card")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--request_timeout", type=float, default=600.0)
    p.add_argument("--dp", type=int, default=1, help="pool rows over N devices (not ported)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel decoder over N devices (not ported)")
    p.add_argument("--rows", type=int, default=32)
    p.add_argument("--max_queue", type=int, default=256,
                   help="reject (429) once this many requests are queued")
    p.add_argument("--max_len", type=int, default=2048)
    p.add_argument("--prefill_buckets", type=int, nargs="+", default=[128, 256, 512, 1024])
    p.add_argument("--chunk_steps", type=int, default=32)
    p.add_argument("--prefill_chunk_tokens", type=int, default=None,
                   help="chunked prefill: admissions fill in pieces of this many tokens, at "
                        "most one piece between decode chunks")
    p.add_argument("--admit_batch", type=int, default=1,
                   help="batch up to N same-bucket queued requests into one admission prefill")
    p.add_argument("--int8_decoder", action="store_true")
    p.add_argument("--int4_decoder", action="store_true")
    p.add_argument("--kv_quant", action="store_true")
    p.add_argument("--kv_bits", type=int, default=8, choices=[8, 4])
    p.add_argument("--draft_llama_path", type=str, default=None,
                   help="speculative decoding draft model (not ported)")
    p.add_argument("--gamma", type=int, default=4)
    p.add_argument("--auto_prefix", action="store_true",
                   help="reuse the longest registered /v1/prefix matching a text request's "
                        "head (no prefix_id needed)")
    p.add_argument("--greedy", action="store_true")
    p.add_argument("--temperature", type=float, default=0.7)
    p.add_argument("--top_p", type=float, default=0.9)
    p.add_argument("--top_k", type=int, default=0)
    return p.parse_args(argv)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    server = build_server(args)
    server.start()
    logger.info("serving on http://%s:%d (rows=%d, buckets=%s, kv_quant=%s)", args.host,
                server.port, args.rows, tuple(args.prefill_buckets),
                server.runner.engine.kv_quant)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        logger.info("shutting down")
        server.stop()


if __name__ == "__main__":
    main()
