"""The port's command line (`python -m shellac_tpu_torch`) on the CPU.

`serve` runs as a subprocess on `--port 0`: it prints its
{"serving": url} line, answers requests with the tokens the port's
engines give in process on the same seed, and exits 0 on SIGINT. A
second `serve` runs in process through `cli.main`, stopped by shutting
its HTTP server down. `generate` and `batch` (run in process through
`cli.main`, as the subprocess already covers `python -m`) print or write
the tokens of the
port's `Engine` and batching engines on the same seed. The serving defaults (the overlap
pipelines, `--decode-ticks auto`, `--max-prefills-per-step`) are the
reference parser's. What the port lacks (a tokenizer.json that is not
byte-level BPE, an MLA model) raises NotImplementedError, and without
`--device cpu` the commands want a card.
"""

import torch_threads  # noqa: F401  (first: one torch thread)

import json
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from shellac_tpu_torch import cli
from shellac_tpu_torch.inference.batching import (
    BatchingEngine,
    PagedBatchingEngine,
)
from shellac_tpu_torch.inference.engine import Engine
from shellac_tpu_torch.models import transformer as tt
from shellac_tpu_torch.models.registry import get_model_config
from shellac_tpu_torch.training.tokenizer import ByteTokenizer

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"
TOK = ByteTokenizer()
# The package is found from the working directory; the interpreter's
# startup hooks (PYTHONPATH) are left out, as the port needs none, and
# the subprocess keeps one torch thread as the tests do.
ENV = torch_threads.ENV


def _cli(capsys, *args):
    """A command's standard output, run in process."""
    capsys.readouterr()
    assert cli.main(list(args)) == 0
    return capsys.readouterr().out


def _model(seed, **over):
    cfg = get_model_config("tiny").replace(**over)
    return cfg, tt.init_params(cfg, seed=seed, device=CPU)


def _post(base, path, payload):
    req = urllib.request.Request(base + path,
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.read().decode()


class _Served:
    """`serve` in a subprocess; stopped with SIGINT, which must exit 0."""

    def __init__(self, *args):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "shellac_tpu_torch", "serve", "--device",
             "cpu", "--port", "0", *args],
            cwd=REPO, env=ENV, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        for line in self.proc.stdout:
            try:
                self.base = json.loads(line)["serving"]
                break
            except (ValueError, KeyError):
                continue
        else:
            raise AssertionError(self.proc.stderr.read())

    def stop(self):
        self.proc.send_signal(signal.SIGINT)
        try:
            rc = self.proc.wait(timeout=60)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
        err = self.proc.stderr.read()
        self.proc.stdout.close()
        self.proc.stderr.close()
        return rc, err


def test_serve_answers_and_stops_on_sigint():
    srv = _Served("--model", "tiny", "--seed", "5", "--slots", "2",
                  "--max-len", "64", "--logprobs")
    try:
        out = json.loads(_post(srv.base, "/generate",
                               {"tokens": [1, 2, 3], "max_new": 5}))
        with urllib.request.urlopen(srv.base + "/metrics", timeout=30) as r:
            metrics = r.read().decode()
        with urllib.request.urlopen(srv.base + "/health", timeout=30) as r:
            assert json.loads(r.read())["ok"] is True
    finally:
        rc, err = srv.stop()
    assert rc == 0, err
    cfg, params = _model(5)
    want = BatchingEngine(cfg, params, n_slots=2, device=CPU).run(
        [("r", np.array([1, 2, 3], np.int32), 5)])["r"]
    assert out["tokens"] == want
    assert 'shellac_requests_total{outcome="ok",tenant=""} 1' in metrics
    assert 'shellac_engine_cache_backend_info{backend="dense"} 1' in metrics


class _ServedInProcess:
    """`serve` run through `cli.main` on a thread of this process (the
    subprocess above covers `python -m` and SIGINT); stopped by shutting
    its HTTP server down, after which `cli.main` must return 0."""

    def __init__(self, monkeypatch, *args):
        from shellac_tpu_torch.inference import server

        made = []
        make = server.make_http_server

        def capture(srv, host, port):
            made.append(make(srv, host, port))
            return made[-1]

        monkeypatch.setattr(server, "make_http_server", capture)
        self.rc = []
        self.thread = threading.Thread(target=lambda: self.rc.append(
            cli.main(["serve", "--device", "cpu", "--port", "0", *args])))
        self.thread.start()
        while not made and self.thread.is_alive():
            time.sleep(0.05)
        assert made, "serve stopped before it served"
        self.httpd = made[0]
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def stop(self):
        self.httpd.shutdown()
        self.thread.join(timeout=60)
        assert not self.thread.is_alive()
        return self.rc[0]


def test_serve_config_over_the_paged_engine(tmp_path, monkeypatch):
    conf = tmp_path / "cfg.json"
    conf.write_text(json.dumps({"preset": "tiny", "dtype": "float32",
                                "n_layers": 1}))
    srv = _ServedInProcess(monkeypatch, "--config", str(conf),
                           "--cache-backend", "paged", "--slots", "2",
                           "--max-len", "64", "--seed", "2")
    msgs = [{"role": "user", "content": "hi"}]
    try:
        native = json.loads(_post(srv.base, "/generate",
                                  {"text": "abc", "max_new": 6,
                                   "stream": True}).splitlines()[-1])
        chat = json.loads(_post(srv.base, "/v1/chat/completions",
                                {"messages": msgs, "max_tokens": 4}))
    finally:
        rc = srv.stop()
    assert rc == 0
    cfg, params = _model(2, dtype="float32", n_layers=1)
    from shellac_tpu_torch.inference.openai_api import render_chat

    eng = PagedBatchingEngine(cfg, params, n_slots=2, device=CPU)
    want = eng.run([("a", TOK.encode("abc"), 6),
                    ("c", TOK.encode(render_chat(msgs, TOK)), 4)])
    assert native["done"] and native["tokens"] == want["a"]
    assert chat["choices"][0]["message"]["content"] == TOK.decode(want["c"])


@pytest.mark.parametrize("mode", ["greedy", "sampled", "stop"])
def test_generate_gives_the_engine_tokens(capsys, mode):
    args = ["generate", "--device", "cpu", "--seed", "4", "--max-new", "7"]
    cfg, params = _model(4)
    text = "hello"
    kw = {}
    if mode == "greedy":
        args += ["--temperature", "0", "--prompt", "5,6,7"]
        prompt, kw = [5, 6, 7], {"temperature": 0.0}
    else:
        args += ["--text", text]
        prompt = TOK.encode(text).tolist()
        kw = {"temperature": 1.0}
    want = Engine(cfg, params, device=CPU, **kw).generate(
        np.asarray([prompt], np.int32), max_new_tokens=7).tokens[0].tolist()
    if mode == "stop":
        stop = want[3:5]
        args += ["--stop", ",".join(map(str, stop))]
        want = want[:next(i for i in range(len(want))
                          if want[i:i + 2] == stop)]
    out = json.loads(_cli(capsys, *args).strip().splitlines()[-1])
    assert out["tokens"] == want


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_batch_gives_the_batching_engine_tokens(capsys, tmp_path, backend):
    rows = [{"prompt": "abc"}, {"prompt": [3, 4, 5, 6], "max_tokens": 3},
            {"prompt": "zz", "max_tokens": 9, "stop": "q"}]
    src, dst = tmp_path / "in.jsonl", tmp_path / "out.jsonl"
    src.write_text("".join(json.dumps(r) + "\n" for r in rows))
    summary = json.loads(_cli(
        capsys, "batch", "--device", "cpu", "--seed", "3", "--input", str(src),
        "--output", str(dst), "--max-new", "5", "--slots", "2",
        "--decode-ticks", "2", "--cache-backend", backend))
    got = [json.loads(ln) for ln in dst.read_text().splitlines()]
    cfg, params = _model(3)
    cls = PagedBatchingEngine if backend == "paged" else BatchingEngine
    eng = cls(cfg, params, n_slots=2, decode_ticks=2, seed=3, device=CPU)
    eng.submit(0, TOK.encode("abc"), 5)
    eng.submit(1, np.array([3, 4, 5, 6], np.int32), 3)
    eng.submit(2, TOK.encode("zz"), 9, stop=[TOK.encode("q").tolist()])
    want = eng.run()
    assert [r["tokens"] for r in got] == [want[i] for i in range(3)]
    assert [r["text"] for r in got] == [TOK.decode(want[i]) for i in range(3)]
    assert summary["requests"] == 3
    assert summary["tokens_generated"] == sum(len(v) for v in want.values())


@pytest.mark.parametrize("kind", ["tokenizer", "train-mesh"])
def test_unported_options_raise(tmp_path, kind):
    """What the port still lacks raises NotImplementedError: a
    tokenizer.json that is not byte-level BPE, and training over a mesh
    (an MLA model trains on one card)."""
    if kind == "tokenizer":
        path = tmp_path / "t.json"
        path.write_text(json.dumps({"model": {"type": "Unigram",
                                              "vocab": []}}))
        argv = ["generate", "--device", "cpu", "--text", "hi",
                "--tokenizer", str(path)]
    else:
        argv = ["train", "--device", "cpu", "--model", "tiny-mla",
                "--mesh", "fsdp=2"]
    with pytest.raises(NotImplementedError):
        cli.main(argv)


@pytest.mark.parametrize("flags", [
    ["--overlap-decode", "--no-overlap-prefill"],
    ["--no-overlap-decode", "--overlap-prefill"],
    ["--decode-ticks", "auto"],
])
def test_pipeline_options_run(tmp_path, flags):
    """The options the port once refused run, and keep the strict
    engine's tokens: each overlap pipeline alone, and the autotuner."""
    src, dst = tmp_path / "in.jsonl", tmp_path / "out.jsonl"
    src.write_text("".join(json.dumps({"prompt": p}) + "\n"
                           for p in ("abc", "hello there", "z")))
    cli.main(["batch", "--device", "cpu", "--seed", "6", "--input",
              str(src), "--output", str(dst), "--max-new", "6", "--slots",
              "2", "--max-len", "48", *flags])
    got = [json.loads(ln)["tokens"] for ln in dst.read_text().splitlines()]
    cfg, params = _model(6)
    want = BatchingEngine(cfg, params, n_slots=2, device=CPU).run(
        [(i, TOK.encode(p), 6)
         for i, p in enumerate(("abc", "hello there", "z"))])
    assert got == [want[i] for i in range(3)]


def test_commands_want_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card path is moot")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["generate", "--prompt", "1,2"])


def _reference_parser():
    from shellac_tpu import cli as jcli

    return jcli.build_parser()


def test_overlap_defaults_are_off():
    """The defaults of the pipeline flags and of --decode-ticks equal the
    reference CLI's (its `serve` leaves the overlap flags None and turns
    them on unless --draft-model is given, which the port lacks)."""
    ref = _reference_parser()
    for cmd in (["batch", "--input", "i", "--output", "o"], ["serve"]):
        args = cli.build_parser().parse_args(cmd)
        want = ref.parse_args(cmd)
        for name in ("overlap_decode", "overlap_prefill"):
            assert getattr(args, name) == (
                True if getattr(want, name) is None
                else getattr(want, name)), (cmd, name)
        assert args.decode_ticks == want.decode_ticks
        assert args.device == "cuda"
    args, want = (p.parse_args(["serve"]) for p in (cli.build_parser(), ref))
    assert args.prefill_chunk == want.prefill_chunk is None


def test_serve_engine_caps_prefills_like_the_reference(monkeypatch):
    """`serve` builds its engine with the reference's default
    --max-prefills-per-step (1), its overlap pipelines and
    --decode-ticks auto, and asks the server for the startup
    autotune. The engine options go to the engine alone: the server
    reads them only when it builds its own engine."""
    from shellac_tpu_torch.inference import server

    seen = {}
    monkeypatch.setattr(server, "serve",
                        lambda cfg, params, **kw: seen.update(kw))
    assert cli.main(["serve", "--device", "cpu", "--port", "0"]) == 0
    eng = seen["engine"]
    want = _reference_parser().parse_args(["serve"])
    assert want.max_prefills_per_step == 1
    assert eng.max_prefills_per_step == want.max_prefills_per_step
    assert set(seen) == {"host", "port", "tokenizer", "model_name",
                         "engine", "max_pending", "autotune"}
    assert eng.overlap_decode and eng.overlap_prefill
    assert eng.decode_ticks_requested == "auto" and seen["autotune"]


def test_serve_prefix_cache_needs_a_paged_backend(monkeypatch):
    """`serve --prefix-cache` builds a prefix-cached paged engine, and
    exits as the reference does (:889) over a dense backend."""
    from shellac_tpu_torch.inference import server

    seen = {}
    monkeypatch.setattr(server, "serve",
                        lambda cfg, params, **kw: seen.update(kw))
    with pytest.raises(SystemExit, match="paged"):
        cli.main(["serve", "--device", "cpu", "--prefix-cache"])
    assert not seen
    for backend in ("paged", "paged-int8"):
        assert cli.main(["serve", "--device", "cpu", "--port", "0",
                         "--cache-backend", backend, "--prefix-cache"]) == 0
        eng = seen["engine"]
        assert eng.prefix_cache and eng.cache_backend.name == backend
        assert eng.stats["prefix_hit_tokens"] == 0
    want = _reference_parser().parse_args(["serve", "--prefix-cache"])
    assert want.prefix_cache
