"""Command-line interface: `python -m shellac_tpu_torch <command>`.

Commands (ports of `shellac_tpu/cli.py`):
  generate  autoregressive sampling (`cmd_generate` :578) through
            `Engine`, or its beam search (`--num-beams`,
            `--length-penalty`, `--eos-id`, `--json-schema`: :677-745)
  batch     offline batch generation, JSONL in and out, through the
            continuous-batching engine (`cmd_batch` :758)
  serve     the HTTP server over the continuous-batching engine
            (`cmd_serve` :859): prints {"serving": "http://host:port"},
            then serves until interrupted (SIGINT exits 0)
  convert   an HF checkpoint directory into a native directory
            (`cmd_convert` :1268)
  train     train a model through `training/loop.py` `fit` (`cmd_train`
            :210, `_train_config` :196, `_data_iter` :90, `_resume_skip`
            :181): token shards (`--data`) or a synthetic stream,
            checkpoints and resume (`--ckpt-dir`), the anomaly sentinel,
            `--optimizer`, `--quant`, `--ema-decay`; prints
            {"final_step": N} last
  eval      the loss and perplexity of a checkpoint (`cmd_eval` :536)
  tokenize  text files into a token shard (`cmd_tokenize` :549)

Everything runs on the card unless `--device cpu` is given. Not ported
(each raises NotImplementedError with a message): `train --mesh`,
`--lora-rank` and `--base-ckpt`, `eval --lora-dir`, `tokenize
--train-bpe`; the `dpo` and `distill` commands are absent. The model is
a preset (`--model`) or a `--config` JSON file of ModelConfig overrides,
which may name a `preset` to start from, with weights from `--ckpt-dir`
(the newest step of a Checkpointer directory; `--ema` takes its EMA
weights, `_restore_params` :144) or else a random init from `--seed`; or
`--native-dir`, a directory `convert` wrote (`_load_native` :111):
`config.json` (`dataclasses.asdict` of the ModelConfig, as the JAX
package's `convert` writes it) and `params.safetensors` (the port's
parameters in serving storage, one tensor per leaf, named by its path:
`embed`, `layers.0.wq`, ..., `final_norm`, `lm_head`). `--tokenizer` is
`byte`, a trained BPE `.json` file or an HF tokenizer directory. The
serving defaults are the reference's: both overlap pipelines on,
`--decode-ticks auto` (the startup autotuner), `--max-prefills-per-step
1`, whole-prompt prefills (`--prefill-chunk` takes a size or `auto`).
`serve --prefix-cache` (:1605) needs a paged backend and exits otherwise
(:889).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _decode_ticks_arg(v: str):
    """--decode-ticks parser: an int >= 1, or 'auto' (the startup sweep
    of candidates on the live engine)."""
    if v == "auto":
        return v
    try:
        return int(v)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--decode-ticks wants an integer or 'auto', got {v!r}"
        )


def _prefill_chunk_arg(v: str):
    """--prefill-chunk parser: an int >= 1, or 'auto' (the startup sweep
    of chunk candidates on the live engine)."""
    if v == "auto":
        return v
    try:
        return int(v)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--prefill-chunk wants an integer or 'auto', got {v!r}"
        )


def _model_config(args):
    from shellac_tpu_torch.config import ModelConfig
    from shellac_tpu_torch.models.registry import PRESETS

    if getattr(args, "config", None):
        with open(args.config) as f:
            raw = json.load(f)
        base = PRESETS[raw.pop("preset")] if "preset" in raw else ModelConfig()
        return base.replace(**raw).validate()
    return PRESETS[args.model].validate()


NATIVE_PARAMS = "params.safetensors"


def _native_config(raw: dict):
    """A ModelConfig from `dataclasses.asdict` output, every nested config
    dataclass rehydrated (the reference's `_load_native` :111-136)."""
    from shellac_tpu_torch.config import (
        Llama3RopeConfig,
        MLAConfig,
        ModelConfig,
        MoEConfig,
        YarnConfig,
    )

    raw = dict(raw)
    nested = {"moe": MoEConfig, "mla": MLAConfig, "rope_yarn": YarnConfig,
              "rope_llama3": Llama3RopeConfig}
    kw = {}
    for name, cls in nested.items():
        d = raw.pop(name, None)
        kw[name] = cls(**d) if d else None
    return ModelConfig(**raw, **kw).validate()


def native_tensors(params):
    """The native directory's tensors of `params`: each leaf named by its
    path (`embed`, `layers.<i>.<name>`, `final_norm`, `lm_head`)."""
    flat = {k: v for k, v in params.items() if k != "layers"}
    for i, lp in enumerate(params["layers"]):
        flat.update({f"layers.{i}.{n}": t for n, t in lp.items()})
    return flat


def _load_native(native_dir, device):
    """(cfg, params on `device`) from a directory `convert` wrote."""
    import os

    from shellac_tpu_torch.models.transformer import check_supported
    from shellac_tpu_torch.ops.dispatch import resolve_device
    from shellac_tpu_torch.utils.safetensors import SafetensorsFile

    with open(os.path.join(native_dir, "config.json")) as f:
        cfg = _native_config(json.load(f))
    check_supported(cfg)
    dev = resolve_device(device)
    f = SafetensorsFile(os.path.join(native_dir, NATIVE_PARAMS))
    flat = {k: f.tensor(k).to(dev, copy=True) for k in f.keys()}
    params = {"embed": flat.pop("embed"), "final_norm": flat.pop("final_norm"),
              "layers": [{} for _ in range(cfg.n_layers)]}
    if "lm_head" in flat:
        params["lm_head"] = flat.pop("lm_head")
    for name, t in flat.items():
        _, i, leaf = name.split(".", 2)
        params["layers"][int(i)][leaf] = t
    _check_params(cfg, params, native_dir)
    return cfg, {k: params[k] for k in ("embed", "layers", "final_norm",
                                        "lm_head") if k in params}


def _check_params(cfg, params, where):
    """Raise unless `params` has this config's leaves and shapes."""
    from shellac_tpu_torch.models.transformer import layer_shapes, moe_layers

    want = {"embed": (cfg.vocab_size, cfg.d_model),
            "final_norm": (cfg.d_model,)}
    if not cfg.tie_embeddings:
        want["lm_head"] = (cfg.d_model, cfg.vocab_size)
    for i, flag in enumerate(moe_layers(cfg)):
        want.update({f"layers.{i}.{n}": shp
                     for n, (shp, _) in layer_shapes(cfg, flag).items()})
    got = {k: tuple(v.shape) for k, v in params.items() if k != "layers"}
    for i, lp in enumerate(params["layers"]):
        got.update({f"layers.{i}.{n}": tuple(v.shape)
                    for n, v in lp.items()})
    if got != want:
        bad = sorted(set(got) ^ set(want)) or sorted(
            k for k in want if got[k] != want[k])
        raise SystemExit(f"{where}: parameters do not match the config "
                         f"({bad[:4]})")


def _restore_params(args, cfg):
    """Params from --ckpt-dir (its newest step; with --ema the averaged
    weights), or a random init from --seed, on --device in serving
    storage."""
    from shellac_tpu_torch.models import transformer

    if getattr(args, "ckpt_dir", None):
        from shellac_tpu_torch.config import TrainConfig
        from shellac_tpu_torch.ops.dispatch import resolve_device
        from shellac_tpu_torch.training.checkpoint import (
            Checkpointer,
            abstract_train_state,
        )

        dev = resolve_device(args.device)
        ckpt = Checkpointer(args.ckpt_dir)
        step = ckpt.latest_step()
        has_ema = step is not None and any(
            p.startswith("ema_params/") for p, _, _ in
            ckpt.item_metadata(step))
        if getattr(args, "ema", False) and not has_ema:
            raise SystemExit("--ema: checkpoint has no EMA parameters "
                             "(train with TrainConfig.ema_decay)")
        # Any decay makes the requested structure carry ema_params, so it
        # matches a checkpoint that has them. The state is read to the
        # host; only the weights served go to the device.
        tcfg = TrainConfig(ema_decay=0.999 if has_ema else None)
        state = ckpt.restore(step, abstract_state=abstract_train_state(
            cfg, tcfg), device="cpu")
        tree = state.ema_params if getattr(args, "ema", False) \
            else state.params

        def serving(name, t):
            return transformer.to_storage(cfg, name, t.detach()).to(dev)

        params = {k: (v if k == "layers" else serving(k, v))
                  for k, v in tree.items()}
        params["layers"] = [{n: serving(n, t) for n, t in lp.items()}
                            for lp in tree["layers"]]
        return params
    return transformer.init_params(cfg, seed=args.seed, device=args.device)


def _model(args):
    """(cfg, params): a native directory, or a config with checkpointed or
    random weights."""
    if getattr(args, "native_dir", None):
        return _load_native(args.native_dir, args.device)
    cfg = _model_config(args)
    return cfg, _restore_params(args, cfg)


def _stop_seqs(args):
    seqs = []
    for part in (args.stop or "").split(";"):
        if not part:
            continue
        try:
            seq = [int(t) for t in part.split(",")]
        except ValueError:
            raise SystemExit(f'--stop: bad token-id sequence {part!r} '
                             '(expected e.g. "13,10;0")')
        seqs.append(seq)
    return seqs


def truncate_at_stop(ids, stop):
    """Cut `ids` at the first occurrence of any stop sequence, excluding
    the match (the reference's `inference/engine.py:490` on one row)."""
    cut = len(ids)
    for s in stop:
        n = len(s)
        for i in range(len(ids) - n + 1):
            if ids[i:i + n] == s:
                cut = min(cut, i)
                break
    return ids[:cut]


def cmd_generate(args):
    from shellac_tpu_torch.inference.engine import Engine
    from shellac_tpu_torch.training.tokenizer import get_tokenizer

    cfg, params = _model(args)
    tok = get_tokenizer(args.tokenizer)
    if args.text is not None:
        prompt = tok.encode(args.text)[None, :].astype(np.int32)
    else:
        if args.prompt is None:
            raise SystemExit("need --prompt or --text")
        prompt = np.array([[int(t) for t in args.prompt.split(",")]],
                          np.int32)
    if prompt.size == 0:
        raise SystemExit("empty prompt")
    stop = _stop_seqs(args)
    eng = Engine(cfg, params, temperature=args.temperature,
                 top_k=args.top_k, top_p=args.top_p, device=args.device)
    constraint = None
    if args.json_schema:
        # Schema-constrained beams, compiled as the server compiles a
        # json_schema constraint.
        if not args.num_beams or args.num_beams < 1:
            raise SystemExit("--json-schema needs --num-beams >= 1 "
                             "(constrained beam search)")
        if args.eos_id is None:
            raise SystemExit("--json-schema needs --eos-id (the DFA's "
                             "EOS column and beam termination must "
                             "agree)")
        if stop:
            # Truncating a schema-constrained beam could leave output
            # outside the schema.
            raise SystemExit("--stop does not compose with --json-schema "
                             "(truncation could break the schema)")
        raw = args.json_schema
        if raw.startswith("@"):
            with open(raw[1:]) as f:
                raw = f.read()
        try:
            schema = json.loads(raw)
        except ValueError as e:
            raise SystemExit(f"--json-schema is not valid JSON: {e}")
        from shellac_tpu_torch.inference.constraints import (
            compile_token_dfa,
            constraint_pattern,
        )

        try:
            constraint = compile_token_dfa(
                constraint_pattern({"json_schema": schema}), tok,
                cfg.vocab_size, args.eos_id)
        except ValueError as e:
            raise SystemExit(f"--json-schema: {e}")
    if args.num_beams and (args.num_beams > 1 or constraint is not None):
        try:
            seqs, scores = eng.beam_search(
                prompt[0], num_beams=args.num_beams,
                max_new_tokens=args.max_new, eos_id=args.eos_id,
                length_penalty=args.length_penalty, constraint=constraint)
        except ValueError as e:
            raise SystemExit(f"beam search: {e}")
        if not seqs:
            raise SystemExit("constrained beam search returned no valid "
                             "beams (max-new too small for the schema?)")
        ids = truncate_at_stop(seqs[0], stop)
        result = {"tokens": ids,
                  "beam_scores": [round(x, 4) for x in scores]}
        if args.text is not None or constraint is not None:
            result["text"] = tok.decode(ids)
        print(json.dumps(result))
        return 0
    out = eng.generate(prompt, max_new_tokens=args.max_new)
    ids = truncate_at_stop(out.tokens[0].tolist(), stop)
    result = {"tokens": ids}
    if args.text is not None:
        result["text"] = tok.decode(ids)
    print(json.dumps(result))
    return 0


def cmd_batch(args):
    """Offline batch generation: JSONL prompts in, JSONL completions out,
    through the continuous-batching engine."""
    from shellac_tpu_torch.inference.cache import engine_class
    from shellac_tpu_torch.training.tokenizer import get_tokenizer

    cfg, params = _model(args)
    tok = get_tokenizer(args.tokenizer)
    eng = engine_class(args.cache_backend)(
        cfg, params, n_slots=args.slots,
        max_len=args.max_len or cfg.max_seq_len,
        temperature=args.temperature, eos_id=args.eos_id,
        decode_ticks=args.decode_ticks,
        overlap_decode=args.overlap_decode,
        overlap_prefill=args.overlap_prefill, seed=args.seed,
        cache_backend=args.cache_backend, logprobs=args.logprobs,
        device=args.device,
    )
    if args.decode_ticks == "auto":
        from shellac_tpu_torch.inference.autotune import maybe_autotune

        maybe_autotune(eng, log=lambda m: print(m, file=sys.stderr))
    rows = []
    with open(args.input) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    if not rows:
        raise SystemExit(f"no prompts in {args.input}")
    per_req = ("max_tokens", "temperature", "top_k", "top_p", "min_p",
               "seed", "presence_penalty", "frequency_penalty")
    for i, row in enumerate(rows):
        prompt = row.get("prompt")
        if isinstance(prompt, str):
            ids = tok.encode(prompt)
        elif isinstance(prompt, list):
            ids = np.asarray(prompt, np.int32)
        else:
            raise SystemExit(f"row {i}: prompt must be text or id list")
        kw = {k: row[k] for k in per_req if row.get(k) is not None}
        max_new = int(kw.pop("max_tokens", args.max_new))
        stop = row.get("stop")
        if stop is not None:
            if isinstance(stop, str):
                stop = [stop]  # OpenAI scalar form: ONE sequence
            try:
                stop = [list(map(int, tok.encode(s)))
                        if isinstance(s, str) else list(map(int, s))
                        for s in stop]
            except TypeError:
                raise SystemExit(
                    f"row {i}: stop must be a string or a list of "
                    "strings / token-id lists"
                )
        try:
            eng.submit(i, ids, max_new, stop=stop, **kw)
        except ValueError as e:
            # A malformed row fails the job before any compute.
            raise SystemExit(f"row {i}: {e}")
    results = dict(eng.run())
    with open(args.output, "w") as f:
        for i in range(len(rows)):
            out = results[i]
            rec = {"index": i, "tokens": out, "text": tok.decode(out)}
            if args.logprobs:
                lps = eng.finished_logprobs.pop(i, None)
                if lps is not None:
                    rec["logprobs"] = lps
            f.write(json.dumps(rec) + "\n")
    print(json.dumps({
        "output": args.output,
        "requests": len(rows),
        "tokens_generated": int(eng.stats["tokens_generated"]),
        "engine_steps": int(eng.stats["engine_steps"]),
    }))
    return 0


def cmd_serve(args):
    import os

    from shellac_tpu_torch.inference.cache import engine_class
    from shellac_tpu_torch.inference.server import serve
    from shellac_tpu_torch.training.tokenizer import get_tokenizer

    if not args.metrics:
        # One switch for the process: engines, the server and the spans
        # deposit into the global registry, which now no-ops every write.
        from shellac_tpu_torch.obs import get_registry

        get_registry().disable()
    if args.prefix_cache and not args.cache_backend.startswith("paged"):
        raise SystemExit("--prefix-cache requires a paged cache backend "
                         "(--cache-backend paged|paged-int8)")
    cfg, params = _model(args)
    paged_extra = ({"prefix_cache": args.prefix_cache}
                   if args.cache_backend.startswith("paged") else {})
    engine = engine_class(args.cache_backend)(
        cfg, params, n_slots=args.slots,
        max_len=args.max_len or cfg.max_seq_len,
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        min_p=args.min_p, eos_id=args.eos_id, seed=args.seed,
        decode_ticks=args.decode_ticks,
        overlap_decode=args.overlap_decode,
        overlap_prefill=args.overlap_prefill,
        max_prefills_per_step=args.max_prefills_per_step,
        prefill_chunk=args.prefill_chunk, logprobs=args.logprobs,
        cache_backend=args.cache_backend, device=args.device, **paged_extra,
    )
    try:
        serve(
            cfg, params, host=args.host, port=args.port,
            tokenizer=get_tokenizer(args.tokenizer),
            model_name=(os.path.basename(os.path.normpath(args.native_dir))
                        if args.native_dir else args.model or "shellac_tpu"),
            engine=engine, max_pending=args.max_pending, autotune=True,
        )
    except KeyboardInterrupt:
        # SIGINT is the stop signal: serve() closed the server on its
        # way out.
        pass
    return 0


def cmd_convert(args):
    """HF checkpoint directory -> native directory: config.json and the
    port's parameters (serving storage) in params.safetensors."""
    import dataclasses
    import os

    from shellac_tpu_torch.models.convert import from_hf
    from shellac_tpu_torch.utils.safetensors import save_file

    cfg, params = from_hf(args.hf_dir, device=args.device)
    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    flat = native_tensors(params)
    save_file(flat, os.path.join(out, NATIVE_PARAMS), {"format": "pt"})
    with open(os.path.join(out, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2)
    print(json.dumps({"out": out,
                      "params": sum(t.numel() for t in flat.values()),
                      "model_type": "moe" if cfg.moe else "dense"}))
    return 0


def _data_iter(args, cfg, batch_size, seq_len, num_batches=None, skip=0):
    """Token shards (`--data`), or the reference's synthetic corpus: a
    noisy periodic stream from `--seed`, so the loss has structure to
    fall on."""
    from shellac_tpu_torch.training.data import shard_batches, token_batches

    if args.data:
        return shard_batches(args.data, batch_size=batch_size,
                             seq_len=seq_len, seed=args.seed,
                             num_batches=num_batches, skip=skip)
    rng = np.random.default_rng(args.seed)
    n = max(seq_len * 64, 1 << 16)
    base = np.arange(n, dtype=np.int32) % min(97, cfg.vocab_size)
    noise = rng.integers(0, cfg.vocab_size, size=n)
    corpus = np.where(rng.random(n) < 0.1, noise, base).astype(np.int32)
    return token_batches(corpus, batch_size=batch_size, seq_len=seq_len,
                         seed=args.seed, num_batches=num_batches, skip=skip)


def _train_config(args):
    from shellac_tpu_torch.config import TrainConfig

    kw = {}
    for field in ("learning_rate", "warmup_steps", "weight_decay",
                  "grad_accum", "seed", "optimizer", "quant", "ema_decay"):
        v = getattr(args, field, None)
        if v is not None:
            kw[field] = v
    kw["total_steps"] = args.steps
    return TrainConfig(**kw)


def _unported(args, flags):
    for flag, attr in flags:
        if getattr(args, attr, None):
            raise NotImplementedError(
                f"{flag} is not ported (the port trains on one card, "
                "without LoRA, and tokenizes with a given tokenizer)")


def cmd_train(args):
    from shellac_tpu_torch.training.loop import fit

    _unported(args, (("--mesh", "mesh"), ("--lora-rank", "lora_rank"),
                     ("--base-ckpt", "base_ckpt")))
    cfg = _model_config(args)
    tcfg = _train_config(args)

    def data_factory(step):
        # fit builds the stream at the step the run starts from (a resume
        # included), and again from the restored step after a rollback:
        # the skip replays exactly the batches the rolled-back steps
        # consumed, so a recovered run ends identical to an unfaulted one.
        return _data_iter(args, cfg, args.batch, args.seq, skip=step)

    state = fit(cfg, tcfg, None, device=args.device,
                checkpoint_dir=args.ckpt_dir,
                checkpoint_every=args.ckpt_every, log_path=args.log_path,
                log_every=args.log_every,
                heartbeat_path=args.heartbeat_file,
                anomaly_action=args.anomaly_action,
                max_restores=args.max_restores, data_factory=data_factory)
    _dump_metrics(args)
    print(json.dumps({"final_step": int(state.step)}))
    return 0


def _dump_metrics(args):
    """train --metrics-file: the shared registry's snapshot as JSON."""
    path = getattr(args, "metrics_file", None)
    if not path:
        return
    from shellac_tpu_torch.obs import get_registry

    with open(path, "w") as f:
        json.dump(get_registry().snapshot(), f, indent=2)
        f.write("\n")


def cmd_eval(args):
    from shellac_tpu_torch.training.evaluate import evaluate

    _unported(args, (("--lora-dir", "lora_dir"),))
    cfg, params = _model(args)
    data = _data_iter(args, cfg, args.batch, args.seq,
                      num_batches=args.batches)
    out = evaluate(cfg, params, data, max_batches=args.batches,
                   device=args.device)
    print(json.dumps({k: round(v, 4) if isinstance(v, float) else v
                      for k, v in out.items()}))
    return 0


def cmd_tokenize(args):
    from shellac_tpu_torch.training.data import write_token_shard
    from shellac_tpu_torch.training.tokenizer import get_tokenizer

    _unported(args, (("--train-bpe", "train_bpe"),))
    tok = get_tokenizer(args.tokenizer)
    docs = []
    for path in args.input:
        with open(path, encoding="utf-8") as f:
            docs.append(f.read())
    tokens = tok.encode_documents(docs)
    write_token_shard(args.output, tokens)
    print(json.dumps({"output": args.output, "tokens": int(tokens.size),
                      "vocab_size": tok.vocab_size}))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="shellac_tpu_torch",
                                description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="command", required=True)

    def common(sp):
        sp.add_argument("--model", default="tiny",
                        help="preset name")
        sp.add_argument("--config", help="JSON file of ModelConfig overrides "
                        '(may include {"preset": name})')
        sp.add_argument("--seed", type=int, default=0,
                        help="seed of the random weights (and sampling)")
        sp.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a card) "
                             "or cpu")
        sp.add_argument("--tokenizer", default="byte",
                        help='"byte", a trained BPE .json file, or a local '
                             "HF tokenizer directory")
        sp.add_argument("--ckpt-dir",
                        help="Checkpointer directory: serve its newest "
                             "step's weights")
        sp.add_argument("--native-dir", dest="native_dir",
                        help="directory written by `convert` (its config "
                             "replaces --model/--config)")

    def overlap(sp):
        sp.add_argument(
            "--overlap-decode", dest="overlap_decode",
            action=argparse.BooleanOptionalAction, default=True,
            help="two-deep decode pipeline: queue window k+1 while the "
                 "host settles window k (greedy outputs are "
                 "token-identical either way; --no-overlap-decode "
                 "restores strict ordering)")
        sp.add_argument(
            "--overlap-prefill", dest="overlap_prefill",
            action=argparse.BooleanOptionalAction, default=True,
            help="in-flight prefills: an admission queues its prefill "
                 "and returns, and every prefill in flight settles at "
                 "the next step boundary (TTFT is marked there)")

    g = sub.add_parser("generate", help="sample tokens")
    common(g)
    g.add_argument("--prompt", help="comma-separated token ids, e.g. 1,5,42")
    g.add_argument("--text", help="text prompt (encoded with --tokenizer)")
    g.add_argument("--max-new", type=int, default=32)
    g.add_argument("--temperature", type=float, default=1.0)
    g.add_argument("--top-k", type=int, default=None)
    g.add_argument("--top-p", type=float, default=None)
    g.add_argument("--stop", default=None,
                   help='token-id stop sequences, e.g. "13,10;0"')
    g.add_argument("--num-beams", type=int, default=None, dest="num_beams",
                   help="beam search with N beams (deterministic; "
                        "ignores temperature/top-k/top-p)")
    g.add_argument("--length-penalty", type=float, default=1.0,
                   dest="length_penalty",
                   help="beam ranking divides scores by len^alpha "
                        "(0 = raw sum, 1 = mean logprob)")
    g.add_argument("--eos-id", type=int, default=None, dest="eos_id",
                   help="EOS token id for beam finishing")
    g.add_argument("--json-schema", default=None, dest="json_schema",
                   help="JSON schema (inline, or @file) compiled to a "
                        "token-DFA constraint for beam search: every "
                        "returned beam satisfies the schema. Needs "
                        "--num-beams and --eos-id")
    g.add_argument("--ema", action="store_true",
                   help="generate with the EMA-averaged weights of "
                        "--ckpt-dir")
    g.set_defaults(fn=cmd_generate)

    backends = ["dense", "dense-int8", "paged", "paged-int8"]
    b = sub.add_parser("batch",
                       help="offline batch generation (JSONL in/out)")
    common(b)
    b.add_argument("--input", required=True,
                   help='JSONL rows: {"prompt": text-or-ids, '
                        '"max_tokens"?, "temperature"?, "stop"?, ...}')
    b.add_argument("--output", required=True, help="JSONL results path")
    b.add_argument("--max-new", type=int, default=64,
                   help="default max tokens when a row has none")
    b.add_argument("--slots", type=int, default=8)
    b.add_argument("--max-len", type=int, default=None, dest="max_len")
    b.add_argument("--temperature", type=float, default=0.0)
    b.add_argument("--eos-id", type=int, default=None, dest="eos_id")
    b.add_argument("--decode-ticks", type=_decode_ticks_arg, default=4,
                   dest="decode_ticks",
                   help="decode steps per host sync, or 'auto' to sweep "
                        "before the drain")
    overlap(b)
    b.add_argument("--cache-backend", default="dense", dest="cache_backend",
                   choices=backends, help="KV-cache storage policy")
    b.add_argument("--logprobs", action="store_true")
    b.set_defaults(fn=cmd_batch)

    s = sub.add_parser("serve", help="HTTP server with continuous batching")
    common(s)
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8000)
    s.add_argument("--slots", type=int, default=8)
    s.add_argument("--max-len", type=int, default=None, dest="max_len")
    s.add_argument("--temperature", type=float, default=0.0)
    s.add_argument("--top-k", type=int, default=None, dest="top_k")
    s.add_argument("--top-p", type=float, default=None, dest="top_p")
    s.add_argument("--min-p", type=float, default=None, dest="min_p")
    s.add_argument("--eos-id", type=int, default=None, dest="eos_id")
    s.add_argument("--cache-backend", default="dense", dest="cache_backend",
                   choices=backends, help="KV-cache storage policy")
    s.add_argument("--prefix-cache", action="store_true", dest="prefix_cache",
                   help="reuse cached KV blocks across prompts sharing a "
                        "prefix (requires a paged backend)")
    s.add_argument("--decode-ticks", type=_decode_ticks_arg,
                   default="auto", dest="decode_ticks",
                   help="decode steps per host sync: an int, or 'auto' "
                        "(the default) to sweep candidates against the "
                        "live engine at startup and keep the fastest")
    overlap(s)
    s.add_argument("--max-prefills-per-step", type=int, default=1,
                   dest="max_prefills_per_step",
                   help="cap prefills per engine step so prompt bursts "
                        "don't stall active decodes")
    s.add_argument("--prefill-chunk", type=_prefill_chunk_arg,
                   default=None, dest="prefill_chunk",
                   help="prefill prompts longer than this incrementally "
                        "(one chunk per step) so a long prompt cannot "
                        "stall active decodes; 'auto' sweeps chunk "
                        "candidates on the live engine at startup")
    s.add_argument("--max-pending", type=int, default=None,
                   dest="max_pending",
                   help="reject new requests with HTTP 429 + Retry-After "
                        "once this many are pending")
    s.add_argument("--metrics", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="Prometheus metrics at GET /metrics (--no-metrics "
                        "no-ops every instrument; the endpoint answers 404)")
    s.add_argument("--logprobs", action="store_true",
                   help="track per-token logprobs so requests may ask "
                        "for them")
    s.set_defaults(fn=cmd_serve)

    def model_args(sp):
        sp.add_argument("--model", default="tiny", help="preset name")
        sp.add_argument("--config", help="JSON file of ModelConfig overrides "
                        '(may include {"preset": name})')
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a card) "
                             "or cpu")

    t = sub.add_parser("train", help="train a model")
    model_args(t)
    t.add_argument("--steps", type=int, default=100)
    t.add_argument("--batch", type=int, default=8)
    t.add_argument("--seq", type=int, default=128)
    t.add_argument("--data", nargs="*", default=None,
                   help="token shard files (default: synthetic stream)")
    t.add_argument("--mesh", default="",
                   help="mesh axes (not ported: raises)")
    t.add_argument("--ckpt-dir")
    t.add_argument("--ckpt-every", type=int, default=500)
    t.add_argument("--log-path")
    t.add_argument("--log-every", type=int, default=10)
    t.add_argument("--metrics-file", default=None, dest="metrics_file",
                   help="write the shared metrics registry's snapshot "
                        "(shellac_train_* series) as JSON at the end")
    t.add_argument("--heartbeat-file", default=None, dest="heartbeat_file",
                   help="liveness file the loop touches at 1 Hz at step "
                        "boundaries, with forced beats around restores")
    t.add_argument("--anomaly-action", default="rollback",
                   dest="anomaly_action",
                   choices=["warn", "skip", "rollback", "fatal"],
                   help="what the anomaly sentinel does about a "
                        "non-finite or spiking loss (rollback restores "
                        "the last-good checkpoint and replays the stream)")
    t.add_argument("--max-restores", type=int, default=2,
                   dest="max_restores",
                   help="skip/rollback recoveries allowed an hour before "
                        "the sentinel escalates to fatal")
    t.add_argument("--learning-rate", type=float, dest="learning_rate")
    t.add_argument("--warmup-steps", type=int, dest="warmup_steps")
    t.add_argument("--weight-decay", type=float, dest="weight_decay")
    t.add_argument("--grad-accum", type=int, dest="grad_accum")
    t.add_argument("--optimizer",
                   choices=["adamw", "lion", "adafactor", "muon"])
    t.add_argument("--quant", choices=["int8", "int8_bwd"], default=None,
                   help="int8 training dots (int8_bwd quantizes the "
                        "backward products too)")
    t.add_argument("--ema-decay", type=float, default=None, dest="ema_decay",
                   help="keep an EMA of the weights (e.g. 0.999)")
    t.add_argument("--lora-rank", type=int, default=None, dest="lora_rank",
                   help="LoRA fine-tuning (not ported: raises)")
    t.add_argument("--base-ckpt", default=None, dest="base_ckpt",
                   help="LoRA base weights (not ported: raises)")
    t.set_defaults(fn=cmd_train)

    e = sub.add_parser("eval", help="perplexity of a checkpoint")
    model_args(e)
    e.add_argument("--ema", action="store_true",
                   help="evaluate the EMA-averaged weights")
    e.add_argument("--batch", type=int, default=8)
    e.add_argument("--seq", type=int, default=128)
    e.add_argument("--batches", type=int, default=16)
    e.add_argument("--data", nargs="*", default=None)
    e.add_argument("--ckpt-dir")
    e.add_argument("--lora-dir", default=None, dest="lora_dir",
                   help="LoRA adapters (not ported: raises)")
    e.set_defaults(fn=cmd_eval)

    k = sub.add_parser("tokenize",
                       help="encode text files into a token shard")
    k.add_argument("--input", nargs="+", required=True, help="text files")
    k.add_argument("--output", required=True, help="shard path to write")
    k.add_argument("--tokenizer", default="byte",
                   help='"byte", a trained BPE .json, or a local HF '
                        "tokenizer dir")
    k.add_argument("--train-bpe", type=int, default=None, dest="train_bpe",
                   metavar="VOCAB_SIZE",
                   help="train a BPE on the inputs first (not ported: "
                        "raises)")
    k.set_defaults(fn=cmd_tokenize)

    c = sub.add_parser("convert",
                       help="HF checkpoint dir -> native params + config")
    c.add_argument("--hf-dir", required=True, dest="hf_dir")
    c.add_argument("--out", required=True)
    c.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    c.set_defaults(fn=cmd_convert)
    return p


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
