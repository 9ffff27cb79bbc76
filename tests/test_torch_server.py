"""The port's HTTP serving front end (`inference/server.py`) over a toy CPU
engine, after tests/test_server.py. Imports no JAX.

Real sockets on port 0: prompt_ids and text prompts, answers equal to a
direct `ServingEngine` run (concurrent requests batching onto one pool),
streaming NDJSON whose deltas add up to the plain answer, /v1/prefix
registration and suffixes equal to the whole prompt, an audio_path request
(a seeded WAV in a temp dir), per-request sampling overrides and their
validation, client errors (400, 404), back-pressure (429) and /healthz and
/v1/stats. `EngineRunner.stop()` fails a staged request and later ones
("shutting down"), and fails a request in flight over HTTP with 503. The
CLI's `build_server` refuses `--dp` / `--tp` > 1 and `--draft_llama_path`
(NotImplementedError naming ROADMAP queue 1) and `--llama_path`, and runs
on the card unless `--platform cpu`.

Every wait is bounded: each urlopen, Event.wait, queue read and thread join
passes a timeout of at most 60 s, and each server fixture's teardown calls
stop().
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from audio_llama_tpu_torch.data import audio_io  # noqa: E402
from audio_llama_tpu_torch.inference import cli  # noqa: E402
from audio_llama_tpu_torch.inference import server as srv_mod  # noqa: E402
from audio_llama_tpu_torch.inference.server import AudioLLMServer, EngineRunner  # noqa: E402
from audio_llama_tpu_torch.inference.serving import ServingEngine  # noqa: E402

WAIT = 60.0  # the bound on every wait in this module


@pytest.fixture(scope="module")
def model():
    cfg, frozen, trainable, tk = cli.load_audio_llm(None, tokenizer="byte", toy_model=True,
                                                     device="cpu")
    return cfg, frozen, trainable, tk


def _engine(model, **kw):
    cfg, frozen, trainable, tk = model
    kw = dict(dict(rows=2, max_len=160, prefill_buckets=(8, 16, 32), chunk_steps=4,
                   compute_dtype=torch.float32, greedy=True, eos_id=tk.eos_id,
                   pad_id=tk.pad_id, audio_start_id=tk.token_to_id(cfg.audio_start_token),
                   audio_end_id=tk.token_to_id(cfg.audio_end_token), device="cpu"), **kw)
    return ServingEngine(frozen, trainable, cfg, **kw)


def _start(model, **kw):
    cfg, tk = model[0], model[3]
    runner = EngineRunner(_engine(model, **kw), poll_interval=0.01)
    return AudioLLMServer(runner, cfg, tokenizer=tk, port=0, request_timeout=WAIT).start()


@pytest.fixture(scope="module")
def server(model):
    srv = _start(model)
    try:
        yield srv
    finally:
        srv.stop()


@pytest.fixture(scope="module")
def stochastic_server(model):
    """Engine defaults stochastic: greedy requests opt in per request."""
    srv = _start(model, rows=4, greedy=False, temperature=0.9, top_p=0.95)
    try:
        yield srv
    finally:
        srv.stop()


def _post(port, path, body, raw=False):
    data = body if raw else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=WAIT) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _post_json(port, path, body, raw=False):
    code, data = _post(port, path, body, raw)
    return code, json.loads(data)


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=WAIT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _direct(model, prompts, max_new, **kw):
    eng = _engine(model, **kw)
    rids = [eng.submit(np.asarray(p, np.int32), max_new_tokens=max_new) for p in prompts]
    out = eng.run(max_chunks=200)
    return [[int(t) for t in out[r]] for r in rids]


def test_generate_prompt_ids_matches_direct_engine(server, model):
    ids = [1, 40, 41, 42]
    code, out = _post_json(server.port, "/v1/generate", {"prompt_ids": ids, "max_new_tokens": 6})
    assert code == 200 and out["n_tokens"] == len(out["tokens"]) > 0
    assert out["tokens"] == _direct(model, [ids], 6)[0]


def test_text_prompt_and_concurrent_requests(server, model):
    code, out = _post_json(server.port, "/v1/generate", {"prompt": "hi", "max_new_tokens": 4})
    assert code == 200 and isinstance(out["text"], str) and out["n_tokens"] > 0
    prompts = [[1, 50 + i, 60 + i] for i in range(5)]
    results = [None] * len(prompts)

    def worker(i):
        results[i] = _post_json(server.port, "/v1/generate",
                                {"prompt_ids": prompts[i], "max_new_tokens": 5})

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT)
    assert not any(t.is_alive() for t in threads)
    for (code, out), want in zip(results, _direct(model, prompts, 5)):
        assert code == 200 and out["tokens"] == want


def test_streaming_matches_plain_request(server):
    body = {"prompt_ids": [1, 70, 71, 72, 73], "max_new_tokens": 9}
    code, plain = _post_json(server.port, "/v1/generate", body)
    assert code == 200
    code, raw = _post(server.port, "/v1/generate", dict(body, stream=True))
    assert code == 200
    events = [json.loads(line) for line in raw.decode().splitlines() if line]
    deltas = [t for e in events[:-1] for t in e["tokens"]]
    assert events[-1]["done"] and events[-1]["n_tokens"] == plain["n_tokens"]
    assert deltas == plain["tokens"] and len(events) >= 2


def test_prefix_roundtrip_and_errors(server, model):
    pre, suf = [1, 80, 81, 82, 83, 84], [85, 86]
    code, out = _post_json(server.port, "/v1/prefix", {"prompt_ids": pre})
    assert code == 200
    pid = out["prefix_id"]
    code, got = _post_json(server.port, "/v1/generate",
                           {"prompt_ids": suf, "prefix_id": pid, "max_new_tokens": 5})
    assert code == 200 and got["tokens"] == _direct(model, [pre + suf], 5)[0]
    assert _post_json(server.port, "/v1/generate",
                      {"prompt_ids": suf, "prefix_id": 999})[0] == 400
    assert _post_json(server.port, "/v1/prefix", {"prompt_ids": pre, "prefix_id": pid})[0] == 400
    assert _post_json(server.port, "/v1/prefix", {"prompt_ids": pre, "top_p": 0.5})[0] == 400
    _, stats = _get(server.port, "/v1/stats")
    assert stats["prefixes"] >= 1 and stats["prefix_admits"] >= 1


def test_audio_path_request(server, model, tmp_path):
    cfg = model[0]
    rng = np.random.default_rng(0)
    wav = (rng.normal(size=(cfg.mel.max_samples,)) * 0.1).astype(np.float32)
    path = tmp_path / "a.wav"
    audio_io.write_wav(str(path), wav, cfg.mel.sample_rate)
    code, out = _post_json(server.port, "/v1/generate",
                           {"prompt": "Transcribe:", "audio_path": str(path),
                            "max_new_tokens": 4})
    assert code == 200 and out["n_tokens"] > 0
    code, out = _post_json(server.port, "/v1/generate",
                           {"prompt": "x", "audio_path": str(tmp_path / "missing.wav")})
    assert code == 400


def test_bad_requests_and_routes(server):
    port = server.port
    assert _post_json(port, "/v1/generate", b"{not json", raw=True)[0] == 400
    assert _post_json(port, "/v1/generate", [1, 2])[0] == 400
    assert _post_json(port, "/v1/generate", {"max_new_tokens": 3})[0] == 400
    assert _post_json(port, "/v1/generate", {"prompt_ids": []})[0] == 400
    assert _post_json(port, "/v1/generate", {"prompt_ids": [1], "max_new_tokens": 0})[0] == 400
    assert _post_json(port, "/v1/nope", {})[0] == 404
    assert _get(port, "/nope")[0] == 404
    # a prompt past every bucket is rejected by admission, not fatal
    code, out = _post_json(port, "/v1/generate", {"prompt_ids": list(range(1, 60))})
    assert code == 400 and "does not fit" in out["error"]
    assert _post_json(port, "/v1/generate", {"prompt_ids": [1, 2], "max_new_tokens": 2})[0] == 200


def test_health_and_stats(server):
    code, h = _get(server.port, "/healthz")
    assert code == 200 and h["ok"] and h["rows"] == 2 and h["errors"] == 0
    assert 0 <= h["live"] <= h["rows"] and h["queued"] >= 0
    code, s = _get(server.port, "/v1/stats")
    assert code == 200 and s["rows"] == 2 and s["chunk_steps"] == 4
    assert s["completed"] <= s["requests"] and s["tokens"] >= s["completed"]
    assert s["prefill_buckets"] == [8, 16, 32] and s["kv_quant"] is False


def test_sampling_overrides(stochastic_server, model):
    port = stochastic_server.port
    ids = [1, 90, 91, 92]
    results = {}

    def worker(key, body):
        results[key] = _post_json(port, "/v1/generate", body)

    threads = [threading.Thread(target=worker, args=(
        "greedy", {"prompt_ids": ids, "max_new_tokens": 6, "greedy": True}))]
    threads += [threading.Thread(target=worker, args=(
        f"s{i}", {"prompt_ids": ids, "max_new_tokens": 6, "temperature": 0.7, "top_p": 0.9}))
        for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT)
    code, out = results["greedy"]
    assert code == 200 and out["tokens"] == _direct(model, [ids], 6)[0]
    assert all(results[f"s{i}"][0] == 200 for i in range(2))
    for bad in ({"temperature": 0}, {"top_p": 1.5}, {"top_k": -1}, {"greedy": "yes"}):
        assert _post_json(port, "/v1/generate", dict({"prompt_ids": ids}, **bad))[0] == 400


def test_backpressure_and_stop_fail_staged_requests(model):
    runner = EngineRunner(_engine(model), max_queue=1)  # the loop is not started
    f1 = runner.submit(np.asarray([1, 2], np.int32), None, 2)
    f2 = runner.submit(np.asarray([1, 2], np.int32), None, 2)
    assert not f1.event.is_set()
    assert f2.event.is_set() and "overloaded" in f2.error
    runner.stop(timeout=1.0)
    assert f1.event.wait(WAIT) and "shutting down" in f1.error
    f3 = runner.submit(np.asarray([1], np.int32), None, 1)
    assert f3.event.is_set() and "shutting down" in f3.error


def test_stop_fails_a_request_in_flight(model):
    # no EOS and a long budget: the request is still decoding when stop() comes
    srv = _start(model, chunk_steps=1, eos_id=-1, max_len=1056)
    result = {}
    try:
        def worker():
            result["r"] = _post_json(srv.port, "/v1/generate",
                                     {"prompt_ids": [1, 2, 3], "max_new_tokens": 1000})

        t = threading.Thread(target=worker)
        t.start()
        for _ in range(int(WAIT / 0.01)):  # until the request holds a row
            if srv.runner.health()["live"]:
                break
            threading.Event().wait(0.01)
        assert srv.runner.health()["live"] == 1
    finally:
        srv.stop()
    t.join(WAIT)
    assert not t.is_alive()
    code, out = result["r"]
    assert code == 503 and "shutting down" in out["error"]


@pytest.mark.parametrize("flags,match", [
    (["--dp", "2"], "ROADMAP queue 1"), (["--tp", "2"], "ROADMAP queue 1"),
    (["--draft_llama_path", "toy"], "ROADMAP queue 1"), (["--llama_path", "/x"], "hf_loader"),
])
def test_build_server_refuses_unported_arms(flags, match):
    args = srv_mod.parse_args(["--platform", "cpu", "--tokenizer", "byte", "--port", "0"] + flags
                              + ([] if "--llama_path" in flags else ["--toy_model"]))
    with pytest.raises(NotImplementedError, match=match):
        srv_mod.build_server(args)


def test_build_server_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = srv_mod.parse_args(["--toy_model", "--tokenizer", "byte", "--port", "0"])
    with pytest.raises(RuntimeError, match="CUDA"):
        srv_mod.build_server(args)
    args = srv_mod.parse_args(["--platform", "cpu", "--toy_model", "--tokenizer", "byte",
                               "--port", "0", "--rows", "2", "--int4_decoder"])
    with pytest.raises(ValueError):  # the toy decoder's hidden 64 < group 128, as the CLI
        srv_mod.build_server(args)
    args = srv_mod.parse_args(["--platform", "cpu", "--toy_model", "--tokenizer", "byte",
                               "--port", "0", "--rows", "2", "--kv_quant", "--kv_bits", "4",
                               "--greedy"])
    srv = srv_mod.build_server(args).start()
    try:
        code, out = _post_json(srv.port, "/v1/generate", {"prompt": "ab", "max_new_tokens": 3})
        assert code == 200 and out["n_tokens"] > 0
        assert srv.runner.engine.device.type == "cpu" and srv.runner.engine.kv_quant == 4
    finally:
        srv.stop()
