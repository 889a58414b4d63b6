"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--seed 0]

Phases, each printing JSON lines; any failure exits non-zero:
  1. device   — the card (torch and nvidia-smi); no CUDA device fails.
  2. build    — compile every kernel in shellac_tpu_torch/csrc/ from source
                (nvcc -Xptxas -v register/shared-memory/spill lines); every
                instance of the Hopper redesigns (the wgmma kernels 2, 3
                and 4, D 64, 128 and 192, with and without segments;
                kernel 1's 34 register-resident RMSNorm instances, bf16
                and fp32, that take every width of whole 16-byte vectors;
                the split-K decode body's dense instances, kernel 5's
                four over bf16 caches and kernel 6's four over int8
                caches (D 64 and 128, at 2 and 16 rows); kernel 7's
                eight, bf16 and int8 pools; at MLA's D 576 the
                tensor-core wide body's four (bf16 q over bf16 and int8
                caches, dense and paged) and the CUDA-core wide body's
                four (fp32 q); the fp32 CUDA-core bodies at D 192:
                kernels 2, 3 and 4) must show 0 spill stores, and no
                wgmma may be serialized (C7520).
  3. kernels  — each kernel against its plain PyTorch version on the card,
                at the shapes of the main paths, in bf16 and fp32 (RMSNorm
                at 1, 8, 16, 4096 and 12288 rows of 2048, 65536 rows of
                128 and 37 x 1000; dense decode at generate's step and at
                B 1 and 16, index 0, a range shorter than one tile or not a
                multiple of the split, index + s = L, a window across
                splits, softcap with sinks, s 4, G 8, D 64); the
                paged kernel reads a pool whose block 0, unowned blocks
                and rows past each slot's length (and before its window)
                hold NaN, at serve's shape and at its split-K edges
                (every slot live to capacity, index 0, a range shorter
                than a tile or not a multiple of the split, a window
                starting mid-page across splits, bs 1, 8, 64 and 128,
                4096-entry tables with few live pages, s 4, G 8, D 64);
                kernel 2's out and lse at generate's prefill
                (8 x 512) and at serve's largest admission (1 x 1024). At
                the training shape (B 6, S 2048, H 16, Hkv 8,
                D 128, causal) and at packed segments, window + softcap +
                sinks, D 64 and an odd S: the forward's lse, the backward
                kernels (dk/dv, dq) against their plain versions, and the
                autograd Function's (dq, dk, dv, dsinks) against autograd
                through the plain attention.
  4. generate — shellac-1b (full width and depth, random weights from
                --seed) through Engine.generate: 8 ragged prompts padded to
                512, 64 new tokens, greedy, every decode step after the
                first a CUDA-graph replay; prefill logits of the kernels
                against the plain attention; kernel launch counts of the
                run and the graphs captured; two later calls at the same
                (batch, pad), which must capture nothing and give the
                same tokens (their prefill wall ms and ms a token); the
                wall ms per decode step
                through the graph and of the same loop run eagerly, whose
                greedy tokens must be equal, and the device-busy share of
                the decode; a depth-cut fp32 run whose greedy tokens must
                equal the plain path's.
  5. serve    — shellac-1b through PagedBatchingEngine.run: 16 slots,
                max_len 2048, 16-token blocks, the default pool; 48
                requests (prompts 64-1024, 16-128 new tokens, greedy)
                submitted up front in strict ordering, after a warm-up
                that captures every prefill bucket's graph, so every
                prefill and window is a CUDA-graph replay; throughput,
                time to first token and
                per output token, launch counts (paged decode = layers x
                ticks, dense decode 0, flash = layers x prefills), the
                graphs captured, the allocator back to pristine, one
                profiled engine step of 16 decoding slots (its device-busy
                share), the wall ms of 20 such steps through the graph and
                of 20 on an engine whose windows run eagerly, and one
                decode step's logits through the kernels against
                attn_impl="ref" on the same cache state (5e-2 of their
                scale).
  5b. serve-overlap — the serve workload with the reference serve's
                scheduling (both overlap pipelines, one prefill a step):
                every sequence equal to serve's, exact launch counts,
                tokens/s, TTFT, TPOT, wall ms per tick and the busy share,
                peak memory and the graphs captured beside serve's; a
                second pass at prefill_chunk 256 whose sequences may part
                from serve's only where the plain model's top-2 margin is
                under CHUNK_MARGIN.
  6. serve-parity — shellac-1b width cut to 2 layers, fp32: identical
                greedy tokens from PagedBatchingEngine through the kernels,
                the same with attn_impl="ref", the dense BatchingEngine,
                and both engines with 64-token chunked prefill under the
                reference serve's scheduling.
  7. train    — shellac-1b (full width and depth, fp32 master weights from
                --seed) through make_train_step at bench.py's recipe:
                TrainConfig(warmup_steps=10, total_steps=1000), batch 6 x
                seq 2048, remat on, inputs = targets; one warm-up step and
                10 timed steps (tokens/s, step ms, model TFLOP/s and its
                share of the card's dense bf16 peak, every loss, peak
                memory, exact launch counts per step), one step with packed
                segment_ids, one profiled step (device ms by kernel kind,
                the LM head's GEMMs apart from the other GEMMs, from a
                profile of the head alone at the step's shapes: bf16
                operands with an fp32 result forward, TF32 backward).
  8. train-parity — shellac-1b width cut to 2 layers, fp32, batch 2 x seq
                512, unpacked and packed: three steps through the kernels
                against the same steps with attn_impl="ref" (loss and
                grad_norm per step, every gradient leaf of the first step).
  9. int8     — the int8 KV cache (kernels 6 and 7's int8 branch):
                kernels-int8: both int8 kernels against their plain versions
                (dequantize in fp32, cast to q's dtype, masked attention) in
                bf16 and fp32, at the generate shape (B 8, L 2048, ragged)
                and the serve-int8 shape (16 slots, 64-token blocks, the
                default pool, NaN scales in block 0 and unowned blocks), with
                window + softcap + sinks, D 64, s 4 and an idle slot, and
                both at the split-K body's edges (kernel 6 as kernel 5's
                above, its scales NaN past each slot's length and before
                its window);
                kernels-beam: kernels 5 and 6 over a beam cache (K 4 and
                16, 1024 positions, two rows equal as after a reorder),
                kernel 7 in bf16 and int8 over copy-on-write tables (rows
                sharing the prompt's sealed blocks, one row sharing
                another's generated blocks, a frozen row's table all
                block 0, lengths on both sides of a block boundary; rows
                no beam attends NaN), in bf16 and fp32;
                generate-int8: Engine(kv_quant="int8").generate on generate's
                prompts (the first token of every row must equal bf16
                generate's, since the prefill is exact; exact launch counts;
                later greedy agreement printed; the graph and eager loops
                as generate's, tokens equal); serve-int8:
                PagedBatchingEngine(cache_backend="paged-int8") on serve's 48
                requests (the serve metrics, the pool's bytes beside a bf16
                pool's, exact launch counts, the decode step's logits
                against attn_impl="ref"); serve-parity-int8: 2 layers,
                fp32, the paged-int8 and dense-int8 engines through the
                kernels against attn_impl="ref" (logprobs within 1e-3, the
                same tokens while the ref's top-2 margin is >= 2e-3).
 10. graph-parity — shellac-1b width cut to 2 layers, bf16: BatchingEngine
                and PagedBatchingEngine over bf16 and int8 caches at 1 and
                4 ticks a window, strict and pipelined, through their CUDA
                graphs (windows and per-bucket prefills) and with both run
                eagerly: greedy tokens and logprobs identical to the eager
                strict engine's, launch counts identical between graph and
                eager runs and to what each run's prefills and windows make;
                per cache, a pass with 64-token chunked prefill (and, over
                the pools, prefix-cache hits) whose continuation graphs
                give the eager programs' tokens, logprobs and launches;
                per cache, at 1 and 4 ticks, strict and pipelined, a
                constrained pass (three grammars and free requests
                sharing the slots; the largest table admitted last, so it
                grows the resident table while windows are in flight)
                bit-equal to its eager twin with equal launch counts;
                per cache, a beam pass (constrained and not, K 1 and 4)
                whose graphs give the eager programs' beams and scores bit
                for bit, and their launches plus the prefill's warm-up.
 11. http-serve — serve's 48 requests over HTTP: InferenceServer over the
                serve phase's PagedBatchingEngine configuration (shellac-1b,
                16 slots, max_len 2048, 16-token blocks, one tick a window,
                greedy) with the reference serve's scheduling,
                make_http_server on 127.0.0.1:0, 16 client threads
                (urllib): 32 to /generate, 8 streamed, 8 to /v1/completions
                with token prompts, after warm-up requests through the
                server (its scheduler thread runs the first eager programs
                and captures the graphs). Every response 200, every token
                sequence equal to serve's in-process run (a mismatch prints
                the first differing position and the plain model's top-2
                margin there), exact launch counts, a /metrics scrape whose
                ok-request and TTFT counts equal the requests answered,
                /health 200, the allocator pristine, the scheduler thread
                gone after close(); tokens/s, the client's TTFT (to the
                first streamed chunk) and wall per request, the server's
                TTFT, queue wait, TPOT and e2e p50/p99 (each request's
                flight-recorder timeline, and the /stats and /metrics
                digests), with serve's numbers beside them.
 11b. prefix-serve — serve's engine under the reference serve's
                scheduling on chat-shaped traffic: 48 requests on one
                shared 1024-token system prompt, tails of 16-256 tokens,
                32-128 new tokens, greedy, with prefix_cache off and on,
                over the bf16 and the int8 pool; each timed run after a
                warm-up captures no graph and makes exactly the launches
                its fresh prefills, suffix prefills and windows make (47
                hits when cached); the hit share, TTFT, TPOT, tokens/s,
                peak memory, a hit's suffix prefill device ms split into
                the plain attention and the rest (a miss's beside it), the
                share of sequences equal to the uncached run's and the
                largest first-token logprob difference (not gated); a
                pass on four system prompts over a 6144-token pool that
                must evict; a 2-layer fp32 copy whose cached and uncached
                tokens must be equal.
 11c. sampling-controls — serve's engine with the per-request controls: a
                seeded request (temperature 0.8) gives the same tokens
                alone, among 15 neighbours (seeded, penalised, biased,
                scoring, sampled) in slot 15, at decode_ticks 1 and 8, and
                with and without the pipelines; a logit bias of +100
                forces its token and -100 bans it; a +100 bias toward a
                token a constrained request's grammar never allows loses;
                prompt logprobs match a plain forward's log-softmax within
                5e-2 of its largest magnitude; four runs of one control
                each capture exactly the window graphs their keys name.
 11d. constrained-serve — serve-overlap's engine (both pipelines, one
                prefill a step, one tick a window, greedy, eos_id 257, the
                byte tokenizer's EOS) over the paged pool, then the
                paged-int8 pool, on serve's 48 requests: a third under a
                finite JSON schema, a third under a finite regex, a third
                free; then the same requests all free. Each pattern's
                compile ms at vocab 32768 and its states, the resident
                table's bytes and one table's upload ms; tokens/s, TTFT
                p50/p99 and TPOT p50 of the constrained and the free
                requests; the device ms of one profiled decode-only step
                of 16 constrained slots and of 16 free ones. Every
                constrained output walks its DFA without meeting -1, every
                one that ended with EOS matches its pattern in full (the
                schema's parse as JSON with its keys), each timed run
                captures 0 graphs and makes exactly the launches its
                prefills and windows make. Then a short HTTP pass
                (InferenceServer with the byte tokenizer): chat
                completions with tools required, a named tool and
                response_format json_schema, streamed and not, whose
                tool_calls arguments and content parse and obey their
                schemas, and /metrics' constraint cache hits and misses.
 11e. beam    — beam search at full width (shellac-1b): one 512-token
                prompt, K 4, 64 new tokens, length penalty 1, through each
                cache's serving engine (BatchingEngine's single-request
                delegate over dense and dense-int8, PagedBatchingEngine's
                copy-on-write search over paged and paged-int8), and on
                paged also K 16 and a prefix hit (a cached 496-token prefix
                attached read-only): per pass the wall ms of a search, the
                ms a step between CUDA events (a whole search less a
                one-step search, over 63), the device ms of a step (its
                graph replayed 20 times back to back), on dense and paged
                one profiled search (device ms by kind, gathers and copies
                apart), the graphs captured by the first search (2) and
                the second (0, with equal beams), exact launch counts,
                peak memory, the pool blocks borrowed, the scores (finite,
                best first);
                whether dense and paged agree on the top beam (reported);
                then an HTTP pass (the paged engine under the reference
                serve's scheduling, 8 streaming clients of 160 tokens,
                alone and beside one num_beams 4 /generate request and one
                /v1/completions request under a json_schema
                response_format): the beams equal the in-process engine's,
                every constrained beam parses and obeys the schema, the
                streams' TPOT p50/p99 and chunk gaps with and without.
 11f. beam-parity — 2 layers, fp32: each cache's beams through the
                kernels against the same search with every kernel swapped
                for its plain version (attn_impl="ref" and RMSNorm's plain
                version): equal sequences, scores within 1e-4; dense
                against paged and dense-int8 against paged-int8 reported.
 11g. moe    — GPT-OSS-20B's shape (`gptoss_20b()`: the published
                config's keys through the port's `config_from_hf`
                mapping; 24 layers, d 2880, 64 q heads over 8 kv heads
                of 64, 32 experts top-4 of width 2880, vocab 201088, a
                128-token window on alternate layers, sinks, q/k/v/o
                biases, yarn rope, dropless; 20.9 B parameters, random
                weights made on the card from --seed) at full width and
                depth (its dropless MoE layers on the sorted-segment
                product in bf16, `transformer.moe_experts`):
                Engine.generate at generate's shape (exact launch
                counts, no capture in the timed call, tokens/s, prefill
                and decode ms, the decode step's device ms by kind and
                one MoE layer's GEMMs against its routing, bucket fill,
                activation and combine), then PagedBatchingEngine on
                serve's 48 requests under the reference serve's
                scheduling (tokens/s, TTFT and TPOT p50/p99, exact
                launch counts, the graphs captured, the allocator
                pristine, a 16-slot decode step by kind, a fresh
                1024-token prefill's device ms, one MoE layer's prefill
                through the capacity buckets against the grouped path,
                peak memory), and the decode step's logits through the
                kernels against attn_impl="ref" with the plain run on
                the kernel run's experts (5e-2 of their scale; the rows
                whose own experts differ are printed). Earlier phases'
                engines are freed first.
 11h. moe-parity — GPT-OSS-20B's shape cut to 2 layers, fp32: greedy
                tokens of Engine, BatchingEngine and PagedBatchingEngine,
                through the kernels and with attn_impl="ref", identical;
                the cached forward's logits against the full forward's
                within 1e-3 of their scale.
 11i. graph-parity-moe — graph-parity's window, prefill and continuation
                passes on GPT-OSS-20B's shape cut to 2 layers, bf16, over
                the paged and dense caches.
 11j. kernels-moe — kernels 1, 2, 5 and 7 at GPT-OSS-20B's shapes (RMSNorm
                at width 2880; 64 q over 8 kv heads of 64 with sinks, the
                128-token window and full attention, at generate's and
                serve's shapes) against their plain versions in bf16 and
                fp32, then timed against their bounds, their plain
                versions and library calls (F.rms_norm; for attention,
                whose sinks no single library call takes on these inputs,
                SDPA with the sink as an extra zero key).
 11k. real-weights — real weights and text in, everything written under
                one temporary directory that is removed at the end:
                shellac-1b at full width and depth with real norm scales
                (0.1 N(0, 1) from --seed), exported through
                `to_state_dict` as an HF Llama directory (config.json
                written here, two bf16 safetensors shards and their
                index), read onto the card by `from_hf` and converted by
                `convert` into a native directory (seconds and GB/s from
                disk to the card, the page cache warm); every leaf must
                come back bit for bit, norm scales as the conversion
                rounds them (s' = float32(bf16(s + 1)) - 1); `generate
                --native-dir --tokenizer tests/fixtures/tokenizer --text`
                in process: the logits at the generated positions against
                the source model's within 5e-2 of their scale, greedy
                tokens equal where the source's top-2 margin allows;
                `serve --native-dir --tokenizer <dir>` in process (its
                HTTP loop on a thread): two rounds of 8 concurrent chat
                completions through the directory's chat template (prompt
                tokens equal to the template's; server TTFT and TPOT from
                each request's timeline, split into the queue wait and
                the prefill to the first token, with what the client
                waited beyond the server's clock, the first round a cold
                start) and one response_format JSON-schema
                request over the BPE vocab that must obey the schema (the
                DFA's compile ms and states at vocab 32768); the train
                recipe's state (fp32 masters, AdamW, after one step)
                saved asynchronously by the Checkpointer (bytes, call and
                commit seconds), restored onto the card, one train step
                from it bit-equal to one from the live state, then the
                newest step torn and restore(fallback=True) landing on the
                one before; 2 layers of GPT-OSS-20B at full width (its
                config from the published keys through `config_from_hf`)
                in GPT-OSS's HF key layout, read back by `from_hf` bit
                for bit, logits and greedy tokens of Engine equal.
 11l. mla     — DeepSeek's latent attention served: shellac-mla-2b (full
                width and depth: d 2048, 20 layers, 16 heads, latent 512 +
                rope 64, nope 128, v 128; random weights from --seed)
                through Engine.generate at generate's shape over the
                dense and dense-int8 latent caches (first tokens equal),
                PagedBatchingEngine on serve's requests over the paged
                and paged-int8 latent pools (the reference serve's
                scheduling), a round of 24 requests on one 1024-token
                system prompt over the prefix-caching pool, and a K = 4
                beam search over that pool (its best beam beside the
                single-request Engine's); then DeepSeek-V2-Lite's shape
                (its published config keys through `config_from_hf`:
                27 layers, 64 routed experts, 6 a token, 2 shared, the
                first layer dense, yarn rope; 15.7 B random parameters)
                through generate and serve over the bf16 caches. Each
                run: exact launch counts (3 RMSNorms an MLA layer), the
                decode through kernels 5-7 at D 576 and every fresh
                prefill through kernel 2 at 192, inside the engines'
                CUDA graphs; tokens/s, TTFT and TPOT p50/p99, a decode
                step's device ms by kind, the cache's bytes beside a GQA
                cache of the same heads, graphs captured, peak memory;
                one decode step's logits through the kernels against the
                plain path (MoE experts pinned).
 11m. mla-parity — shellac-mla-2b cut to 2 layers, fp32: Engine, the dense
                and the paged batching engines over the latent caches,
                through the kernels and with attn_impl="ref", identical
                greedy tokens; the cached forward (expanded prefill,
                absorbed decode) against the full forward within 1e-3 of
                its scale.
 11n. kernels-mla — kernels 1, 2 and 5-7 at MLA's widths (RMSNorm at 512;
                the flash forward at 192; the absorbed decode at 576 over
                the dense cache, bf16 (16 heads and DeepSeek-V2/V3's 128)
                and int8, and the pools, bf16 blocks
                of 16 and int8 of 64, poisoned with NaN wherever no slot
                attends) against their plain versions in bf16 and fp32,
                then timed against their bounds, plain versions and
                library calls (F.rms_norm; SDPA at 192; masked SDPA over
                the latent as k and v at 576, after a dequantize or a
                gather where the kernel reads int8 or a pool). Their rows
                join the kernels line as `<kernel>_d192` / `_d576`. A
                bf16 call at 576 must launch the tensor-core body
                (`decode_wide_mma`) alone, over either cache and pool,
                an fp32 call the CUDA-core one (`bodies_d576`, by the
                profiler's kernel names).
 12. cli-serve — `python -m shellac_tpu_torch serve --config F
                --cache-backend paged --slots 4 --port 0 --logprobs` (F:
                shellac-1b cut to 2 layers) as a subprocess, on the CLI's
                serving defaults (both pipelines, `--decode-ticks auto`,
                one prefill a step): its {"serving": url} line and the
                seconds to it, two blocking, one streamed and one chat
                request whose tokens equal an in-process
                PagedBatchingEngine's on the same config and seed (the chat
                by its decoded text, token count and per-token logprobs),
                /stats showing the tuned decode_ticks and both pipelines,
                and exit code 0 on SIGINT.
 13. timings  — each kernel's device time (CUDA-graph replay timed by CUDA
                events; the eager time beside it) against its bound, its
                plain version and one PyTorch library call computing the
                same (for the paged kernel there is none: a gather plus
                scaled_dot_product_attention, two calls, is timed beside
                it; for the int8 kernels a dequantize plus SDPA, two calls,
                and a gather, a dequantize and SDPA, three calls; for the
                backward kernels the library call is the backward of
                scaled_dot_product_attention, which computes what kernels 3
                and 4 compute together). RMSNorm is timed at prefill's 4096,
                train's 12288, generate's 8 and serve's 16 rows; kernel 2
                at generate's prefill, at serve's largest admission (B 1, S
                1024) and at the training shape; the dense decode (bf16 and
                int8) at generate's step and with every slot live to 2048;
                the paged kernel and its int8 branch at serve's and
                serve-int8's ragged steps and with every slot live to 2048;
                every row carries its achieved TFLOP/s.
 Training, whole (the `train-*` phases and `cli-train`):
  kernels-train  — kernels 2 (with packed segments), 3 and 4 at MLA's head
                width 192 against their plain versions in bf16 and fp32
                at MLA's training shape (6 x 2048, 16 heads, v padded from
                128), packed, and at S 1999, the Function against autograd
                through the plain attention; that a bf16 call of kernel 3
                or 4 runs its wgmma body alone; their card ms, plain ms,
                bound and SDPA (backward) ms;
  train-families — shellac-mla-2b at full size, DeepSeek-V2-Lite's width
                at 4 layers and GPT-OSS-20B's at 2 (fused loss, and the
                peak memory without it): a few timed adamw steps with
                remat, tokens/s, model TFLOP/s (6 N + 12 L D S, N active),
                peak memory, device ms by kernel kind and kernels 3 and
                4's share of it;
  train-options  — shellac-1b at 6 x 2048 under lion, adafactor, muon,
                int8 and int8_bwd dots, remat "dots" and "dots_no_batch",
                grad_accum 2 at 12 x 2048 and the EMA; shellac-270m's
                forward on (2, 512);
  train-parity   — also 2-layer fp32 steps of shellac-mla-2b and
                DeepSeek-V2-Lite through the kernels against the plain
                attention;
  cli-train      — `python -m shellac_tpu_torch train` with a checkpoint,
                a resume and `eval`, the resumed run against an
                uninterrupted one.
Then the card's name and power limit, one {"kernels": [...]} line, and as
the last line {"ok": true, "device": {...}}. `--only PHASES` (generate,
prefix-serve, sampling-controls, constrained-serve, graph-parity, beam,
beam-parity, kernels-beam, moe, moe-parity, graph-parity-moe,
kernels-moe, real-weights, mla, mla-parity, kernels-mla, kernels-train,
train-families, train-options, train-parity, cli-train) runs those after
the build and prints neither of the last two lines.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# Published H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit).
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
BF16_PEAK_NAME = "H100 SXM dense bf16, 989 TFLOP/s"

PROMPTS, PAD, NEW_TOKENS, MAX_LEN = 8, 512, 64, 2048
LEN_LO, LEN_HI = 128, 512
# The serve workload; serve-int8 runs it over 64-token int8 blocks.
SLOTS, BLOCK, REQUESTS = 16, 16, 48
BLOCK_INT8 = 64
PROMPT_LO, PROMPT_HI, NEW_LO, NEW_HI = 64, 1024, 16, 128
# Constrained decoding: the byte tokenizer's EOS, a finite JSON schema and
# a finite regex (every path ends in EOS within serve's budgets), and the
# tools of the HTTP pass (finite parameters).
EOS_BYTE = 257
CON_SCHEMA = {"type": "object", "properties": {
    "city": {"enum": ["oslo", "rio", "lima", "pune"]},
    "days": {"enum": [1, 2, 3, 7]}, "ok": {"type": "boolean"},
    "unit": {"const": "celsius"}},
    "required": ["city", "days", "ok", "unit"]}
CON_REGEX = r"(yes|no|maybe)( (yes|no|maybe)){0,3}"
TOOLS = [
    {"type": "function", "function": {
        "name": "get_weather", "description": "weather lookup",
        "parameters": {"type": "object", "properties": {
            "city": {"enum": ["oslo", "rio"]}, "days": {"enum": [1, 2, 3]}},
            "required": ["city", "days"]}}},
    {"type": "function", "function": {
        "name": "calc", "description": "arithmetic",
        "parameters": {"type": "object", "properties": {
            "op": {"enum": ["add", "mul"]}}, "required": ["op"]}}},
]
# The train workload: bench.py's recipe.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 6, 2048, 10


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def reset_peak():
    """Free what earlier phases left (a batching engine and its backend
    reference each other, so only the cycle collector frees them) and
    restart the peak-memory count."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# kernels under test
# --------------------------------------------------------------------------


# Instances the build must show, by kind: the wgmma kernels (D 64, 128
# and MLA's 192, with and without segments), the fp32 CUDA-core bodies
# at 192 (kernels 3 and 4, kernel 2 with and without segments), kernel
# 1's register-resident RMSNorm (bf16 and fp32, 17 each: many rows at
# 16, 32, 64, 128 and 256 threads a row, few rows at a CTA a row, and the
# exact-fit twins of the six that d 2048 and 128 land on), the
# split-K decode body (D 64 and 128, at 2 and 16 rows) over the dense
# caches (kernel 5's bf16, kernel 6's int8) and kernel 7's bf16 and int8
# pools, and at MLA's 576 the tensor-core wide body (bf16 q over bf16 and
# int8 caches) and the CUDA-core one (fp32 q, over fp32 and int8 caches),
# each over the dense caches and the pools.
REDESIGNED = {"flash_fwd": 6, "flash_bwd_dkdv": 6, "flash_bwd_dq": 6,
              "flash_bwd_dkdv_simt": 1, "flash_bwd_dq_simt": 1,
              "flash_fwd_f32": 2,
              "rms_norm_rows": 34, "decode_split": 8, "paged_split": 8,
              "decode_wide_mma": 2, "paged_wide_mma": 2,
              "decode_wide": 2, "paged_wide": 2}


def spill_report(ptxas):
    """Each instance of the redesigned kernels (REDESIGNED) with its
    registers and spill stores from the `ptxas -v` lines, and whether
    ptxas serialized any wgmma (warning C7520)."""
    import re

    out, fn = [], None
    for line in ptxas:
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        if fn is None:
            continue
        if "_wgmma" in fn:
            kind = next((k for k in ("flash_fwd", "flash_bwd_dkdv",
                                     "flash_bwd_dq") if k in fn), fn)
        elif "Li192E" in fn and ("_simt" in fn or "flash_fwd_f32" in fn):
            # The fp32 CUDA-core instances at MLA's D 192 (kernels 3 and
            # 4, kernel 2 with and without segments).
            kind = next(k for k in ("flash_bwd_dkdv_simt",
                                    "flash_bwd_dq_simt", "flash_fwd_f32")
                        if k in fn)
        elif "decode_split" in fn or "decode_wide" in fn:
            # The tiles policy names the kernel; at 576 the tensor-core
            # body (`decode_wide_mma`) and the CUDA-core one
            # (`decode_wide_kernel`) count apart.
            body = ("split" if "decode_split" in fn else
                    "wide_mma" if "decode_wide_mma" in fn else "wide")
            kind = ("paged_" if "PagedTiles" in fn else "decode_") + body
        else:
            kind = "rms_norm_rows" if "rms_norm_rows" in fn else None
            if kind is None:
                continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            out.append({"kernel": kind, "instance": fn,
                        "spill_stores": int(m.group(1))})
        m = re.search(r"Used (\d+) registers", line)
        if m and out and out[-1]["instance"] == fn:
            out[-1]["registers"] = int(m.group(1))
            fn = None
    counts = {k: sum(i["kernel"] == k for i in out) for k in REDESIGNED}
    return {"instances": out, "counts": counts,
            "c7520": any("C7520" in line for line in ptxas)}


def kernel_table():
    from shellac_tpu_torch.ops import decode_attention as da
    from shellac_tpu_torch.ops import flash_attention as fa
    from shellac_tpu_torch.ops import norms

    return [
        {"name": "rms_norm", "route": "cuda",
         "source": "shellac_tpu_torch/csrc/rms_norm.cu",
         "replaces": "shellac_tpu/ops/norms.py:50",
         "wrapper": norms.rms_norm_cuda},
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "shellac_tpu_torch/csrc/flash_attention.cu",
         "replaces": "shellac_tpu/ops/flash_attention.py:226",
         "wrapper": fa.flash_attention_cuda},
        {"name": "decode_attention_dense", "route": "cuda",
         "source": "shellac_tpu_torch/csrc/decode_attention.cu",
         "replaces": "shellac_tpu/ops/decode_attention.py:315",
         "wrapper": da.decode_attention_cuda},
        {"name": "paged_decode_attention", "route": "cuda",
         "source": "shellac_tpu_torch/csrc/paged_decode_attention.cu",
         "replaces": "shellac_tpu/ops/decode_attention.py:562",
         "also_replaces": "shellac_tpu/ops/decode_attention.py:764",
         "wrapper": da.paged_decode_attention_cuda},
        {"name": "flash_attention_bwd_dkdv", "route": "cuda",
         "source": "shellac_tpu_torch/csrc/flash_attention_bwd.cu",
         "replaces": "shellac_tpu/ops/flash_attention.py:401",
         "wrapper": fa.flash_bwd_dkdv_cuda},
        {"name": "flash_attention_bwd_dq", "route": "cuda",
         "source": "shellac_tpu_torch/csrc/flash_attention_bwd.cu",
         "replaces": "shellac_tpu/ops/flash_attention.py:454",
         "wrapper": fa.flash_bwd_dq_cuda},
        {"name": "decode_attention_dense_int8", "route": "cuda",
         "source": "shellac_tpu_torch/csrc/decode_attention.cu",
         "replaces": "shellac_tpu/ops/decode_attention.py:334",
         "wrapper": da.decode_attention_quant_cuda},
        {"name": "paged_decode_attention_int8", "route": "cuda",
         "source": "shellac_tpu_torch/csrc/paged_decode_attention.cu",
         "replaces": "shellac_tpu/ops/decode_attention.py:562 (quant)",
         "wrapper": da.paged_decode_attention_quant_cuda},
    ]


def reset_counts(table):
    for k in table:
        k["wrapper"].launches = 0


def read_counts(table):
    return {k["name"]: k["wrapper"].launches for k in table}


def only(table, **counts):
    """Expected launch counts: the given ones, every other kernel 0."""
    return {k["name"]: counts.get(k["name"], 0) for k in table}


# Tolerances: fp32 is the algorithm check (summation order only differs:
# 2e-5 as the JAX package's attention tests use, 1e-5 for a norm); bf16
# outputs are rounded to bf16 (2^-8 relative) and attention rounds p to
# bf16 too, so a few output ulps: atol + rtol * |ref|.
TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2e-2, 2e-2)}


def compare(out, ref, dtype):
    atol, rtol = TOL[dtype]
    err = (out.float() - ref.float()).abs()
    bound = atol + rtol * ref.float().abs()
    rel = (err / ref.float().abs().clamp_min(1e-6)).max().item()
    return {
        "max_abs_err": err.max().item(),
        "max_rel_err": rel,
        "atol": atol, "rtol": rtol,
        "ok": bool(torch.isfinite(out.float()).all().item()
                   and (err <= bound).all().item()),
    }


def compare_scaled(out, ref, dtype):
    """As compare, with atol relative to the output's scale: |out - ref|
    <= atol * max|ref| + rtol * |ref| (gradients sum many terms)."""
    atol, rtol = TOL[dtype]
    err = (out.float() - ref.float()).abs()
    scale = ref.float().abs().max()
    bound = atol * scale + rtol * ref.float().abs()
    return {
        "max_abs_err": err.max().item(),
        "max_err_over_scale": (err.max() / scale.clamp_min(1e-30)).item(),
        "atol_rel_scale": atol, "rtol": rtol,
        "ok": bool(torch.isfinite(out.float()).all().item()
                   and (err <= bound).all().item()),
    }


def main_shapes(seed, dev):
    """Shapes the shellac-1b main path gives each kernel; the decode
    index is ragged in [LEN_LO, LEN_HI + 64], as the decode steps see."""
    idx = torch.from_numpy(
        np.random.default_rng(seed)
        .integers(LEN_LO, LEN_HI + NEW_TOKENS + 1, size=PROMPTS)
        .astype(np.int32)
    ).to(dev)
    # The serve phase's decode: 16 slots at lengths up to prompt + new.
    serve_idx = np.random.default_rng(seed + 1).integers(
        PROMPT_LO, PROMPT_HI + NEW_HI + 1, size=SLOTS).astype(np.int32)
    return {
        "rms_prefill": (PROMPTS * PAD, 2048),
        "rms_decode": (PROMPTS, 2048),
        "rms_train": (TRAIN_BATCH * TRAIN_SEQ, 2048),
        "rms_serve_decode": (SLOTS, 2048),
        "flash": dict(b=PROMPTS, s=PAD, h=16, hkv=8, d=128),
        # serve's largest admission: one prompt of PROMPT_HI tokens.
        "flash_serve": dict(b=1, s=PROMPT_HI, h=16, hkv=8, d=128),
        "decode": dict(b=PROMPTS, s=1, h=16, hkv=8, L=MAX_LEN, d=128,
                       index=idx),
        "paged": dict(s=1, h=16, hkv=8, d=128, bs=BLOCK,
                      max_blocks=MAX_LEN // BLOCK,
                      index=torch.from_numpy(serve_idx).to(dev)),
        # serve-int8's decode: the default pool of 64-token blocks.
        "paged_int8": dict(s=1, h=16, hkv=8, d=128, bs=BLOCK_INT8,
                           max_blocks=MAX_LEN // BLOCK_INT8,
                           min_blocks=SLOTS * MAX_LEN // 2 // BLOCK_INT8 + 1,
                           index=torch.from_numpy(serve_idx).to(dev)),
        "train": dict(b=TRAIN_BATCH, s=TRAIN_SEQ, h=16, hkv=8, d=128),
    }


def randn(gen, shape, dtype, dev, std=1.0):
    return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)


def rms_inputs(gen, rows, d, dtype, dev):
    return randn(gen, (rows, d), dtype, dev), randn(
        gen, (d,), torch.float32, dev, 0.1)


def flash_inputs(gen, dtype, dev, b, s, h, hkv, d):
    return (randn(gen, (b, s, h, d), dtype, dev),
            randn(gen, (b, s, hkv, d), dtype, dev),
            randn(gen, (b, s, hkv, d), dtype, dev))


def decode_inputs(gen, dtype, dev, b, s, h, hkv, L, d, index):
    return (randn(gen, (b, s, h, d), dtype, dev),
            randn(gen, (b, hkv, L, d), dtype, dev),
            randn(gen, (b, hkv, L, d), dtype, dev), index)


def paged_tables(gen, dev, s, bs, max_blocks, index, idle=(), unowned=64,
                 min_blocks=1025, window=None):
    """Tables giving each slot shuffled pages for positions [0, index + s)
    (rows padded with block 0); slots in `idle` get length 0 and an
    all-zero row. Returns (tables, index, live, n_blocks): `live`
    (n_blocks, bs) marks the rows some slot attends, from its window's
    first position (0 without one) to its length; block 0, unowned
    blocks and the rest of each slot's pages are not live."""
    index = index.clone()
    index[list(idle)] = 0
    need = [0 if b in idle else -(-(int(i) + s) // bs)
            for b, i in enumerate(index.tolist())]
    n_blocks = max(min_blocks, 1 + sum(need) + unowned)
    ids = torch.randperm(n_blocks - 1, generator=gen, device=dev) + 1
    tables = torch.zeros((len(need), max_blocks), dtype=torch.int32,
                         device=dev)
    at = 0
    for b, n in enumerate(need):
        tables[b, :n] = ids[at:at + n].to(torch.int32)
        at += n
    pos = torch.arange(max_blocks * bs, device=dev)[None, :]
    first = (0 if window is None
             else (index[:, None].long() - window + 1).clamp_min(0))
    attended = ((pos < index[:, None].long() + s) & (pos >= first)
                & torch.tensor([n > 0 for n in need], device=dev)[:, None])
    pages = tables.long().gather(1, (pos // bs).expand(len(need), -1))
    live = torch.zeros((n_blocks, bs), dtype=torch.bool, device=dev)
    live[pages[attended], (pos % bs).expand(len(need), -1)[attended]] = True
    return tables, index, live, n_blocks


def paged_inputs(gen, dtype, dev, s, h, hkv, d, bs, max_blocks, index,
                 idle=(), min_blocks=1025, window=None):
    """q, a pool holding each slot's pages in shuffled blocks, the tables
    and index (`paged_tables`), and a poisoned copy of the pool whose
    rows no slot attends (block 0, unowned blocks, rows past each slot's
    length and before its window) are NaN."""
    tables, index, live, n_blocks = paged_tables(
        gen, dev, s, bs, max_blocks, index, idle, min_blocks=min_blocks,
        window=window)
    q = randn(gen, (len(index), s, h, d), dtype, dev)
    k = randn(gen, (n_blocks, hkv, bs, d), dtype, dev)
    v = randn(gen, (n_blocks, hkv, bs, d), dtype, dev)
    pk, pv = k.clone(), v.clone()
    dead = ~live[:, None, :].expand(n_blocks, hkv, bs)
    pk[dead] = float("nan")
    pv[dead] = float("nan")
    return q, k, v, tables, index, pk, pv


def quant_rows(gen, shape, dev):
    """Seeded normals (..., D) quantized as a cache write would: int8
    values and fp32 scales of shape[:-1]."""
    from shellac_tpu_torch.inference.cache import quantize_kv

    q, sc = quantize_kv(torch.randn(shape, generator=gen, device=dev)[None])
    return q[0].contiguous(), sc[0].contiguous()


def decode_quant_inputs(gen, dtype, dev, b, s, h, hkv, L, d, index):
    """q, an int8 dense cache (B, Hkv, L, D) and its scales, index."""
    ck, ks = quant_rows(gen, (b, hkv, L, d), dev)
    cv, vs = quant_rows(gen, (b, hkv, L, d), dev)
    return randn(gen, (b, s, h, d), dtype, dev), ck, cv, ks, vs, index


def paged_quant_inputs(gen, dtype, dev, s, h, hkv, d, bs, max_blocks, index,
                       idle=(), min_blocks=1025, window=None):
    """q, an int8 pool and its scale pools, the tables and index
    (`paged_tables`), and poisoned copies of the scale pools whose rows
    no slot attends (block 0, unowned blocks, rows past each slot's
    length and before its window) are NaN."""
    tables, index, live, n_blocks = paged_tables(
        gen, dev, s, bs, max_blocks, index, idle, min_blocks=min_blocks,
        window=window)
    q = randn(gen, (len(index), s, h, d), dtype, dev)
    k, ks = quant_rows(gen, (n_blocks, hkv, bs, d), dev)
    v, vs = quant_rows(gen, (n_blocks, hkv, bs, d), dev)
    pks, pvs = ks.clone(), vs.clone()
    dead = ~live[:, None, :].expand(n_blocks, hkv, bs)
    pks[dead] = float("nan")
    pvs[dead] = float("nan")
    return q, k, v, ks, vs, tables, index, pks, pvs


def paged_cases(sinks16, other_bs, main, dev):
    """The paged kernel's cases over serve's shape (or serve-int8's):
    name -> (shape overrides, among them the lengths `index` where they
    are not serve's, keyword arguments, idle slots). Past the first
    ones, the split-K body's edges:
    every slot live to the table's capacity, index 0, a live range
    shorter than a tile or not a multiple of the split, a window whose
    first live position (700 - 199 = 501) falls mid-page so that a tile
    covers 3 pages across the cluster's CTAs, bs 1 (32 page segments a
    tile) and bs 128 (a page longer than a tile), a 4096-entry table with
    few live pages, G 8 (16 rows). `other_bs` is the other serving block
    size (64 for bf16, 16 for int8)."""
    def blocks(n, **shape):
        return {"bs": n, "max_blocks": MAX_LEN // n, **shape}

    def at(*lengths, **shape):
        return {"index": torch.tensor(lengths, dtype=torch.int32,
                                      device=dev), **shape}

    return {
        main: ({}, {}, ()),
        f"bs{other_bs}": (blocks(other_bs), {}, ()),
        "bs8": (blocks(8), {}, ()),
        "d64": ({"d": 64}, {}, ()),
        "window_softcap_sinks": ({}, {"window": 200, "softcap": 50.0,
                                      "sinks": sinks16}, ()),
        "s4": ({"s": 4}, {}, ()),
        "idle_slot": ({}, {}, (3,)),
        "full_capacity": (at(*[MAX_LEN - 1] * 4), {}, ()),
        "index_0": (at(0, 0), {}, ()),
        "shorter_than_a_tile": (at(5), {}, ()),
        "tiles_not_a_multiple_of_split": (at(529, 163, 289), {}, ()),
        "window_mid_page_across_splits": (
            blocks(16, **at(700, 129, 2047, 64)), {"window": 200}, ()),
        "bs1": (blocks(1), {}, ()),
        "bs128": (blocks(128, **at(5, 127, 1000, 2047)), {}, ()),
        "max_blocks_4096_few_live": (
            at(5, 100, 33, 300, bs=16, max_blocks=4096), {}, ()),
        "g8_16_rows": (at(17, 2046, s=2, hkv=2), {}, ()),
    }


def dense_edges():
    """The dense split-K body's edges (kernels 5 and 6): 32-position tiles
    dealt to the CTAs of a cluster. name -> (shape overrides, lengths,
    keyword arguments)."""
    return {
        "b1_shorter_than_a_tile": ({"b": 1}, [5], {}),
        "b16_ragged": ({"b": 16}, [0, 1, 31, 32, 33, 255, 256, 257,
                                   300, 511, 512, 999, 1023, 1500,
                                   2046, 2047], {}),
        "index_0": ({"b": 2}, [0, 0], {}),
        "tiles_not_a_multiple_of_split": ({"b": 3}, [529, 163, 289], {}),
        "index_plus_s_is_L": ({"b": 4}, [MAX_LEN - 1] * 4, {}),
        "window_across_splits": ({"b": 4}, [700, 129, 2047, 64],
                                 {"window": 200}),
        "g8_16_rows": ({"b": 2, "s": 2, "hkv": 2}, [17, 2046], {}),
    }


def phase_kernels(gen, dev, shapes):
    from shellac_tpu_torch.ops.decode_attention import (
        _decode_ref,
        _paged_decode_ref,
        decode_attention_cuda,
        paged_decode_attention_cuda,
    )
    from shellac_tpu_torch.ops.flash_attention import (
        flash_attention_cuda,
        flash_attention_ref,
        flash_forward_ref,
    )
    from shellac_tpu_torch.ops.norms import rms_norm_cuda, rms_norm_ref

    results, failed = {}, []

    def record(kernel, case, dtype, out, ref, main=False, rows=None):
        torch.cuda.synchronize()
        if rows is not None:
            out, ref = out[rows], ref[rows]
        res = compare(out, ref, dtype)
        emit("kernels", kernel=kernel, case=case, dtype=str(dtype), **res)
        if main:
            results[kernel] = res["max_abs_err"]
        if not res["ok"]:
            failed.append((kernel, case, str(dtype)))

    sinks16 = randn(gen, (16,), torch.float32, dev)
    for dtype in (torch.bfloat16, torch.float32):
        main = dtype == torch.bfloat16
        for case in ("rms_prefill", "rms_decode", "rms_train",
                     "rms_serve_decode"):
            x, sc = rms_inputs(gen, *shapes[case], dtype, dev)
            record("rms_norm", case, dtype, rms_norm_cuda(x, sc, 1e-5),
                   rms_norm_ref(x, sc, 1e-5), main and case == "rms_prefill")
        # One row; q/k norms (4096 tokens x 16 heads of 128); a width
        # with no register-resident instance.
        for case, rows, d in (("rms_1x2048", 1, 2048),
                              ("qk_norm_65536x128", 65536, 128),
                              ("ragged_37x1000", 37, 1000)):
            x, sc = rms_inputs(gen, rows, d, dtype, dev)
            record("rms_norm", case, dtype, rms_norm_cuda(x, sc),
                   rms_norm_ref(x, sc))

        # Kernel 2 at generate's prefill and at serve's largest admission,
        # out and lse against flash_forward_ref.
        for case, fs in (("main_causal", shapes["flash"]),
                         ("serve_b1_s1024", shapes["flash_serve"])):
            q, k, v = flash_inputs(gen, dtype, dev, **fs)
            out, lse = flash_attention_cuda(q, k, v, causal=True,
                                            with_lse=True)
            rout, rlse = flash_forward_ref(q, k, v, causal=True)
            record("flash_attention_fwd", case, dtype, out, rout,
                   main and case == "main_causal")
            record("flash_attention_fwd", f"{case}/lse", dtype, lse, rlse)
        fs = shapes["flash"]
        q, k, v = flash_inputs(gen, dtype, dev, **fs)
        kw = dict(causal=True, window=128, softcap=50.0, sinks=sinks16)
        record("flash_attention_fwd", "window_softcap_sinks", dtype,
               flash_attention_cuda(q, k, v, **kw),
               flash_attention_ref(q, k, v, **kw))
        q, k, v = flash_inputs(gen, dtype, dev, **{**fs, "d": 64, "s": 333})
        record("flash_attention_fwd", "d64_ragged_s333", dtype,
               flash_attention_cuda(q, k, v, causal=True),
               flash_attention_ref(q, k, v, causal=True))
        q, k, v = flash_inputs(gen, dtype, dev, **{**fs, "b": 2})
        record("flash_attention_fwd", "noncausal_b2", dtype,
               flash_attention_cuda(q, k, v, causal=False),
               flash_attention_ref(q, k, v, causal=False))

        ds = shapes["decode"]
        q, ck, cv, idx = decode_inputs(gen, dtype, dev, **ds)
        scale = ds["d"] ** -0.5
        record("decode_attention_dense", "main_ragged", dtype,
               decode_attention_cuda(q, ck, cv, idx),
               _decode_ref(q, ck, cv, idx, None, scale), main)
        record("decode_attention_dense", "window_softcap_sinks", dtype,
               decode_attention_cuda(q, ck, cv, idx, window=200,
                                     softcap=50.0, sinks=sinks16),
               _decode_ref(q, ck, cv, idx, 200, scale, softcap=50.0,
                           sinks=sinks16))
        q, ck, cv, idx = decode_inputs(gen, dtype, dev, **{**ds, "d": 64})
        record("decode_attention_dense", "d64", dtype,
               decode_attention_cuda(q, ck, cv, idx),
               _decode_ref(q, ck, cv, idx, None, 64 ** -0.5))
        q, ck, cv, idx = decode_inputs(gen, dtype, dev, **{**ds, "s": 4})
        record("decode_attention_dense", "s4_causal_rows", dtype,
               decode_attention_cuda(q, ck, cv, idx),
               _decode_ref(q, ck, cv, idx, None, scale))
        # The split-K body's edges: 32-position tiles dealt to the CTAs
        # of a cluster.
        edges = dense_edges()
        for case, (shape, lengths, kw) in edges.items():
            es = {**ds, **shape,
                  "index": torch.tensor(lengths, dtype=torch.int32,
                                        device=dev)}
            q, ck, cv, idx = decode_inputs(gen, dtype, dev, **es)
            record("decode_attention_dense", case, dtype,
                   decode_attention_cuda(q, ck, cv, idx, **kw),
                   _decode_ref(q, ck, cv, idx, kw.get("window"), scale))

        # Paged: the kernel reads the NaN-poisoned pool, the plain
        # version the clean one; the live rows are the same.
        ps = shapes["paged"]
        for case, (shape, kw, idle) in paged_cases(
                sinks16, 64, "main_serve_bs16", dev).items():
            p = {**ps, **shape}
            q, k, v, tab, idx, pk, pv = paged_inputs(
                gen, dtype, dev, **p, idle=idle, window=kw.get("window"))
            d = p["d"]
            live = [b for b in range(len(idx)) if b not in idle]
            out = paged_decode_attention_cuda(q, pk, pv, tab, idx, **kw)
            ref = _paged_decode_ref(q, k, v, tab, idx, kw.get("window"),
                                    d ** -0.5, softcap=kw.get("softcap"),
                                    sinks=kw.get("sinks"))
            record("paged_decode_attention", case, dtype, out, ref,
                   main and case == "main_serve_bs16", rows=live)
            del q, k, v, pk, pv
    if failed:
        raise SystemExit(f"kernels disagree with their plain versions: "
                         f"{failed}")
    return results


def phase_kernels_int8(gen, dev, shapes):
    """Both int8 kernels against their plain versions (dequantize in fp32,
    cast to q's dtype, masked attention) at the generate and serve-int8
    shapes and at the split-K body's edges. The kernels read scales that
    are NaN in every row no slot attends, the plain versions the clean
    ones."""
    from shellac_tpu_torch.ops.decode_attention import (
        _decode_ref,
        _paged_decode_ref,
        decode_attention_quant_cuda,
        paged_decode_attention_quant_cuda,
    )

    results, failed = {}, []
    sinks16 = randn(gen, (16,), torch.float32, dev)
    wss = {"window": 200, "softcap": 50.0, "sinks": sinks16}
    dense_cases = {"main_ragged": ({}, {}), "window_softcap_sinks": ({}, wss),
                   "d64": ({"d": 64}, {}), "s4_causal_rows": ({"s": 4}, {})}
    for dtype in (torch.bfloat16, torch.float32):
        main = dtype == torch.bfloat16

        def record(kernel, case, out, ref, is_main, rows=None):
            torch.cuda.synchronize()
            if rows is not None:
                out, ref = out[rows], ref[rows]
            res = compare(out, ref, dtype)
            emit("kernels-int8", kernel=kernel, case=case, dtype=str(dtype),
                 **res)
            if is_main:
                results[kernel] = res["max_abs_err"]
            if not res["ok"]:
                failed.append((kernel, case, str(dtype)))

        for case, (shape, kw) in dense_cases.items():
            p = {**shapes["decode"], **shape}
            q, ck, cv, ks, vs, idx = decode_quant_inputs(gen, dtype, dev, **p)
            record("decode_attention_dense_int8", case,
                   decode_attention_quant_cuda(q, ck, cv, ks, vs, idx, **kw),
                   _decode_ref(q, ck, cv, idx, kw.get("window"),
                               p["d"] ** -0.5, softcap=kw.get("softcap"),
                               sinks=kw.get("sinks"), k_scale=ks,
                               v_scale=vs),
                   main and case == "main_ragged")
        # Kernel 5's split-K edges over the int8 cache; the kernel reads
        # scales poisoned with NaN past each slot's length (and before its
        # window), the plain version the clean ones.
        for case, (shape, lengths, kw) in dense_edges().items():
            p = {**shapes["decode"], **shape,
                 "index": torch.tensor(lengths, dtype=torch.int32,
                                       device=dev)}
            q, ck, cv, ks, vs, idx = decode_quant_inputs(gen, dtype, dev, **p)
            pos = torch.arange(p["L"], device=dev)[None, :]
            end = idx[:, None].long() + p["s"]
            dead = pos >= end
            if kw.get("window") is not None:
                dead |= pos <= idx[:, None].long() - kw["window"]
            dead = dead[:, None, :].expand_as(ks)
            pks, pvs = ks.masked_fill(dead, float("nan")), \
                vs.masked_fill(dead, float("nan"))
            record("decode_attention_dense_int8", f"split_{case}",
                   decode_attention_quant_cuda(q, ck, cv, pks, pvs, idx,
                                               **kw),
                   _decode_ref(q, ck, cv, idx, kw.get("window"),
                               p["d"] ** -0.5, k_scale=ks, v_scale=vs),
                   False)
            del q, ck, cv, ks, vs, pks, pvs
        for case, (shape, kw, idle) in paged_cases(
                sinks16, 16, "main_serve_int8_bs64", dev).items():
            p = {**shapes["paged_int8"], **shape}
            q, k, v, ks, vs, tab, idx, pks, pvs = paged_quant_inputs(
                gen, dtype, dev, **p, idle=idle, window=kw.get("window"))
            live = [b for b in range(len(idx)) if b not in idle]
            out = paged_decode_attention_quant_cuda(q, k, v, pks, pvs, tab,
                                                    idx, **kw)
            ref = _paged_decode_ref(q, k, v, tab, idx, kw.get("window"),
                                    p["d"] ** -0.5, softcap=kw.get("softcap"),
                                    sinks=kw.get("sinks"), k_scale=ks,
                                    v_scale=vs)
            record("paged_decode_attention_int8", case, out, ref,
                   main and case == "main_serve_int8_bs64", rows=live)
            del k, v, ks, vs, pks, pvs
    if failed:
        raise SystemExit(f"int8 kernels disagree with their plain versions: "
                         f"{failed}")
    return results


def packed_segments(b, s, dev):
    """bench.py --packed: four documents per row, boundaries off block
    edges (bench.py:224-230)."""
    bounds = [0, s // 4 + 37, s // 2 + 11, 3 * s // 4 + 5, s]
    seg = torch.zeros((b, s), dtype=torch.int32, device=dev)
    for i in range(4):
        seg[:, bounds[i]:bounds[i + 1]] = i
    return seg


def phase_kernels_train(gen, dev, shapes):
    """The training path's attention kernels against their plain versions:
    the forward's out and lse (the logsumexp of the masked scores with the
    sink column, `flash_forward_ref`), kernels 3 and 4 on the kernel
    forward's out and lse, and the autograd Function's gradients against
    autograd through the plain attention. Gradients are held relative to
    their scale (compare_scaled)."""
    from shellac_tpu_torch.ops import flash_attention as fa

    f32, bf = torch.float32, torch.bfloat16
    cases = {
        "train_causal": ({}, {}),
        "train_packed": ({}, {"packed": True}),
        "window_softcap_sinks": ({"b": 2}, {"window": 512, "softcap": 50.0,
                                            "sinks": True}),
        "d64": ({"b": 2, "d": 64}, {}),
        "odd_s1999": ({"b": 2, "s": 1999}, {"packed": True}),
    }
    results, failed = {}, []

    def check(kernel, case, dtype, res, main=False):
        emit("kernels", kernel=kernel, case=case, dtype=str(dtype), **res)
        if main:
            results[kernel] = max(results.get(kernel, 0.0),
                                  res["max_abs_err"])
        if not res["ok"]:
            failed.append((kernel, case, str(dtype)))

    for dtype in (bf, f32):
        for case, (shape, opts) in cases.items():
            p = {**shapes["train"], **shape}
            b, s, h, hkv, d = p["b"], p["s"], p["h"], p["hkv"], p["d"]
            main = case == "train_causal" and dtype == bf
            q, k, v = flash_inputs(gen, dtype, dev, b, s, h, hkv, d)
            do = randn(gen, (b, s, h, d), dtype, dev)
            seg = packed_segments(b, s, dev) if opts.get("packed") else None
            sinks = (randn(gen, (h,), f32, dev) if opts.get("sinks")
                     else None)
            kw = dict(causal=True, window=opts.get("window"),
                      softcap=opts.get("softcap"), segments=seg)
            out, lse = fa.flash_attention_cuda(q, k, v, sinks=sinks,
                                               with_lse=True, **kw)
            rout, rlse = fa.flash_forward_ref(q, k, v, sinks=sinks, **kw)
            torch.cuda.synchronize()
            check("flash_attention_fwd", f"{case}/out", dtype,
                  compare(out, rout, dtype))
            check("flash_attention_fwd", f"{case}/lse", dtype,
                  compare(lse, rlse, dtype))
            del rout, rlse
            delta = torch.einsum("bshd,bshd->bhs", do.float(),
                                 out.float()).contiguous()
            dk, dv = fa.flash_bwd_dkdv_cuda(q, k, v, do, lse, delta, **kw)
            dq = fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, **kw)
            torch.cuda.synchronize()
            rdk, rdv = fa.flash_bwd_dkdv_ref(q, k, v, do, lse, delta, **kw)
            check("flash_attention_bwd_dkdv", f"{case}/dk", dtype,
                  compare_scaled(dk, rdk, dtype), main)
            check("flash_attention_bwd_dkdv", f"{case}/dv", dtype,
                  compare_scaled(dv, rdv, dtype), main)
            del rdk, rdv
            rdq = fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, **kw)
            check("flash_attention_bwd_dq", f"{case}/dq", dtype,
                  compare_scaled(dq, rdq, dtype), main)
            del rdq, dk, dv, dq, out, lse, delta
            leaves = [q, k, v] + ([sinks] if sinks is not None else [])
            grads = {}
            for impl, fn in (("function", fa.flash_attention),
                             ("autograd_ref", fa.flash_attention_ref)):
                ins = [t.detach().clone().requires_grad_() for t in leaves]
                sk = ins[3] if sinks is not None else None
                grads[impl] = torch.autograd.grad(
                    fn(*ins[:3], sinks=sk, **kw), ins, do)
                del ins
            torch.cuda.synchronize()
            for name, g, w in zip(("dq", "dk", "dv", "dsinks"),
                                  grads["function"], grads["autograd_ref"]):
                check("flash_attention_function", f"{case}/{name}", dtype,
                      compare_scaled(g, w, dtype))
            del grads, q, k, v, do
            torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"training kernels disagree with their plain "
                         f"versions: {failed}")
    return results


# --------------------------------------------------------------------------
# main path
# --------------------------------------------------------------------------


def prompts(seed, vocab, dev):
    rng = np.random.default_rng(seed)
    lens = rng.integers(LEN_LO, LEN_HI + 1, size=PROMPTS).astype(np.int32)
    toks = rng.integers(0, vocab, size=(PROMPTS, PAD)).astype(np.int64)
    return torch.from_numpy(toks).to(dev), torch.from_numpy(lens).to(dev)


def eager_engine(cls):
    """`cls` (Engine or a batching engine) with its decode loop run
    eagerly, tick by tick, and a batching engine's prefills run eagerly
    too: the programs its CUDA graphs replace."""
    from shellac_tpu_torch import Engine
    from shellac_tpu_torch.inference.batching import _NO_CTL

    if issubclass(cls, Engine):
        class Eager(cls):
            def _graph(self, fn, generator, pool=None):
                return fn
    else:
        class Eager(cls):
            def _decode_impl(self, greedy_only, ctl=_NO_CTL):
                return self._window(greedy_only, ctl)

            def _prefill_replay(self, key):
                return self._program(key)

            def _graph(self, fn, generator, pool=None):
                # The beam programs (the paged search's, and the dense
                # caches' delegate, which takes the engine's runner).
                return fn
    return Eager


def prefill_graphs(engine):
    """Prefill buckets of a batching engine captured as CUDA graphs."""
    return sum(g.graph is not None for g in engine._prefill_graphs.values())


def decode_loops(engine, eager, toks, lens):
    """Engine.generate's decode loop (NEW_TOKENS steps from a fresh
    prefill) through its CUDA graph, twice, and the same loop run eagerly
    by `eager` (an `eager_engine` of the same settings) between them:
    wall ms per decode step of each, whether their greedy tokens are
    equal, the graphs captured, and the device time and busy share of a
    profiled graph loop (its first, eager step and the capture
    included)."""
    from shellac_tpu_torch.inference.graphs import StepGraph

    out = {}

    def loop(eng):
        first, cache, seen = eng._prefill_impl(toks, lens)
        gen = torch.Generator(device=toks.device)
        gen.manual_seed(0)
        torch.cuda.synchronize()
        return lambda: eng._decode_impl(first, cache, NEW_TOKENS, gen, seen)

    for name, eng in (("graph", engine), ("eager", eager), ("graph", engine)):
        run = loop(eng)
        captured = StepGraph.captures
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / (NEW_TOKENS - 1)
        out.setdefault(name, []).append((res.tokens, ms,
                                         StepGraph.captures - captured))
        del run
    prof = profile_call(loop(engine))
    graph, eager_run = out["graph"], out["eager"][0]
    return dict(
        graph_ms_per_tick=[ms for _, ms, _ in graph],
        eager_ms_per_tick=eager_run[1],
        graphs_captured_per_loop=[n for _, _, n in graph + [eager_run]],
        graph_tokens_equal_eager=all(torch.equal(t, eager_run[0])
                                     for t, _, _ in graph),
        graph_loop_device_ms=prof["device_ms"],
        graph_loop_wall_ms=prof["wall_ms"],
        graph_loop_device_busy_share=prof["device_busy_share"],
        graph_loop_trace_lost=prof["trace_lost"])


def phase_generate(seed, dev, table, card):
    from shellac_tpu_torch import Engine, get_model_config
    from shellac_tpu_torch.inference.cache import init_cache
    from shellac_tpu_torch.inference.graphs import StepGraph
    from shellac_tpu_torch.models import transformer

    cfg = get_model_config("shellac-1b")
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    emit("generate", step="init_params", model="shellac-1b",
         params=transformer.num_params(params),
         seconds=time.perf_counter() - t0)
    toks, lens = prompts(seed, cfg.vocab_size, dev)

    # Prefill logits through the kernels against the plain attention.
    logits = {}
    with torch.inference_mode():
        for impl in ("auto", "ref"):
            cache = init_cache(cfg, PROMPTS, MAX_LEN, dev)
            logits[impl], _ = transformer.forward_with_cache(
                cfg, params, toks, cache, new_tokens_len=lens,
                fresh_cache=True, attn_impl=impl,
            )
            del cache
    got, ref = logits["auto"], logits["ref"]
    scale = ref.abs().max().item()
    err = (got - ref).abs().max().item()
    ok = bool(torch.isfinite(got).all().item()) and err <= 5e-2 * scale
    rows = torch.arange(PROMPTS, device=dev)
    last = (lens - 1).long()
    agree = (got[rows, last].argmax(-1) == ref[rows, last].argmax(-1))
    emit("generate", step="prefill_logits_auto_vs_ref",
         shape=list(got.shape), max_abs_err=err, ref_max_abs=scale,
         tol="max_abs_err <= 5e-2 * max|ref|",
         last_argmax_agree=int(agree.sum().item()), ok=ok)
    if not ok:
        raise SystemExit("prefill logits: kernels disagree with plain path")
    del logits, got, ref

    engine = Engine(cfg, params, max_len=MAX_LEN, temperature=0.0,
                    device=dev)
    engine.generate(toks, lens, max_new_tokens=4)  # warm-up (cuBLAS init)
    torch.cuda.synchronize()
    reset_peak()

    reset_counts(table)
    captured = StepGraph.captures
    t0 = time.perf_counter()
    res = engine.generate(toks, lens, max_new_tokens=NEW_TOKENS)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = read_counts(table)
    captured = StepGraph.captures - captured
    peak = torch.cuda.max_memory_allocated()

    expect = only(table, rms_norm=(2 * cfg.n_layers + 1) * NEW_TOKENS,
                  flash_attention_fwd=cfg.n_layers,
                  decode_attention_dense=cfg.n_layers * (NEW_TOKENS - 1))
    tokens_ok = (tuple(res.tokens.shape) == (PROMPTS, NEW_TOKENS)
                 and bool(((res.tokens >= 0)
                           & (res.tokens < cfg.vocab_size)).all().item())
                 and bool(torch.isfinite(res.logprobs).all().item())
                 and bool((res.logprobs <= 1e-6).all().item()))
    emit("generate", step="main_path", launches=counts, expected=expect,
         graphs_captured=captured,
         tokens_shape=list(res.tokens.shape), tokens_ok=tokens_ok,
         total_s=total_s, tokens_per_s=PROMPTS * NEW_TOKENS / total_s,
         max_memory_allocated=peak, card=card)
    if counts != expect or not tokens_ok:
        raise SystemExit("main path: wrong launch counts or bad tokens")

    # Two later calls at the same (batch, pad): the engine keeps its
    # prefill and decode-step programs across calls, so they replay
    # their graphs and capture nothing. The call of one token is the
    # prefill (and its first token) alone.
    later = []
    for max_new in (NEW_TOKENS, 1):
        before = StepGraph.captures
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = engine.generate(toks, lens, max_new_tokens=max_new)
        torch.cuda.synchronize()
        later.append(((time.perf_counter() - t0) * 1e3,
                      StepGraph.captures - before, out))
    (call_ms, call_caps, again), (prefill_ms, prefill_caps, _) = later
    replay_ok = (call_caps == prefill_caps == 0
                 and bool(torch.equal(again.tokens, res.tokens)))
    emit("generate", step="calls_after_the_first",
         captures_by_call=[captured, call_caps, prefill_caps],
         call_wall_ms=call_ms, prefill_wall_ms=prefill_ms,
         decode_ms_per_token=(call_ms - prefill_ms) / (NEW_TOKENS - 1),
         tokens_equal_to_main_path=replay_ok, card=card)
    if not replay_ok:
        raise SystemExit("generate: a later call at the same shape captured "
                         "a graph or changed its tokens")

    # Split timing of the same run: prefill, then the decode loop through
    # its CUDA graph, beside the same loop run eagerly.
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first, cache, seen = engine._prefill_impl(toks, lens)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        # One decode step (the cached forward) captured in a CUDA graph at
        # the prompts' lengths: its device time. It rewrites the row the
        # first decode step writes, with the same token.
        tok = res.tokens[:, :1].long()
        step_ms = graph_ms(
            lambda: transformer.forward_with_cache(cfg, params, tok, cache),
            [()], 1)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        res2 = engine._decode_impl(first, cache, NEW_TOKENS, gen, seen)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        loops = decode_loops(engine, eager_engine(Engine)(
            cfg, params, max_len=MAX_LEN, temperature=0.0, device=dev),
            toks, lens)
        profile_step(cfg, params, toks, lens, engine, dev)
    same = bool(torch.equal(res2.tokens, res.tokens))
    graph_tick = (t3 - t2) * 1e3 / (NEW_TOKENS - 1)
    emit("generate", step="timing", prefill_ms=(t1 - t0) * 1e3,
         decode_ms_per_token=graph_tick,
         decode_step_device_ms=step_ms,
         decode_step_busy_share=step_ms / graph_tick,
         tokens_per_s=PROMPTS * NEW_TOKENS / (t1 - t0 + t3 - t2),
         max_memory_allocated=peak, rerun_tokens_equal=same, card=card,
         **loops)
    if not same:
        raise SystemExit("greedy generation is not deterministic")
    if not loops["graph_tokens_equal_eager"]:
        raise SystemExit("generate: greedy tokens through the CUDA graph "
                         "differ from the eager loop's")
    del engine, params, cache, first, seen
    torch.cuda.empty_cache()

    # Depth-cut fp32 copy: greedy tokens of the kernels must equal the
    # plain path's (fp32 kernels differ from it by summation order only).
    cfg32 = cfg.replace(n_layers=2, dtype="float32")
    p32 = transformer.init_params(cfg32, seed=seed, device=dev)
    out = {}
    for impl in ("auto", "ref"):
        eng = Engine(cfg32, p32, max_len=MAX_LEN, temperature=0.0,
                     attn_impl=impl, device=dev)
        out[impl] = eng.generate(toks, lens, max_new_tokens=16)
    eq = bool(torch.equal(out["auto"].tokens, out["ref"].tokens))
    lp_err = (out["auto"].logprobs - out["ref"].logprobs).abs().max().item()
    emit("generate", step="fp32_depth2_auto_vs_ref_tokens", equal=eq,
         logprob_max_abs_err=lp_err, tol_logprob=1e-3)
    if not eq or lp_err > 1e-3:
        raise SystemExit("fp32 greedy tokens differ between kernels and "
                         "plain path")
    del p32, out
    torch.cuda.empty_cache()
    return counts, res.tokens


def phase_generate_int8(seed, dev, table, card, bf16_tokens):
    """Engine(kv_quant="int8").generate on generate's prompts and budget.
    The prefill attends its exact chunk, so every row's first token must
    equal bf16 generate's; later tokens read K and V rounded to int8, and
    how long each row's greedy run agrees with bf16 is printed, not
    gated."""
    from shellac_tpu_torch import Engine, get_model_config
    from shellac_tpu_torch.inference.graphs import StepGraph
    from shellac_tpu_torch.models import transformer

    cfg = get_model_config("shellac-1b")
    params = transformer.init_params(cfg, seed=seed, device=dev)
    toks, lens = prompts(seed, cfg.vocab_size, dev)
    engine = Engine(cfg, params, max_len=MAX_LEN, temperature=0.0,
                    kv_quant="int8", device=dev)
    engine.generate(toks, lens, max_new_tokens=4)  # warm-up
    torch.cuda.synchronize()
    reset_peak()

    reset_counts(table)
    captured = StepGraph.captures
    t0 = time.perf_counter()
    res = engine.generate(toks, lens, max_new_tokens=NEW_TOKENS)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = read_counts(table)
    captured = StepGraph.captures - captured
    peak = torch.cuda.max_memory_allocated()
    L = cfg.n_layers
    expect = only(table, rms_norm=(2 * L + 1) * NEW_TOKENS,
                  flash_attention_fwd=L,
                  decode_attention_dense_int8=L * (NEW_TOKENS - 1))
    tokens_ok = (tuple(res.tokens.shape) == (PROMPTS, NEW_TOKENS)
                 and bool(((res.tokens >= 0)
                           & (res.tokens < cfg.vocab_size)).all().item())
                 and bool(torch.isfinite(res.logprobs).all().item()))
    first_equal = bool(torch.equal(res.tokens[:, 0], bf16_tokens[:, 0]))
    same = (res.tokens == bf16_tokens).int()
    agree_prefix = torch.cumprod(same, dim=1).sum(dim=1).tolist()
    with torch.inference_mode():
        _, cache, _ = engine._prefill_impl(toks, lens)
        cache_bytes = pool_bytes(cache)
        tok = res.tokens[:, :1].long()
        step_ms = graph_ms(
            lambda: transformer.forward_with_cache(cfg, params, tok, cache),
            [()], 1)
        loops = decode_loops(engine, eager_engine(Engine)(
            cfg, params, max_len=MAX_LEN, temperature=0.0, kv_quant="int8",
            device=dev), toks, lens)
    emit("generate-int8", step="timing", decode_step_device_ms=step_ms,
         decode_step_busy_share=step_ms / loops["graph_ms_per_tick"][0],
         card=card, **loops)
    emit("generate-int8", step="main_path", launches=counts,
         expected=expect, graphs_captured=captured, tokens_ok=tokens_ok,
         first_token_equals_bf16=first_equal,
         greedy_prefix_agreeing_with_bf16=agree_prefix,
         tokens_equal_to_bf16=int(same.sum().item()),
         tokens=PROMPTS * NEW_TOKENS, total_s=total_s,
         tokens_per_s=PROMPTS * NEW_TOKENS / total_s,
         decode_step_device_ms=step_ms, cache_bytes=cache_bytes,
         bf16_cache_bytes=2 * L * PROMPTS * cfg.kv_heads * MAX_LEN
         * cfg.dim_per_head * 2,
         max_memory_allocated=peak, card=card)
    if counts != expect or not tokens_ok or not first_equal:
        raise SystemExit("generate-int8: wrong launch counts, bad tokens or "
                         "a first token that differs from bf16")
    if not loops["graph_tokens_equal_eager"]:
        raise SystemExit("generate-int8: greedy tokens through the CUDA "
                         "graph differ from the eager loop's")
    del engine, params, cache
    torch.cuda.empty_cache()
    return counts


def profile_step(cfg, params, toks, lens, engine, dev):
    """Device time by kernel for one prefill and one decode step."""
    from shellac_tpu_torch.models import transformer

    first, cache, _ = engine._prefill_impl(toks, lens)
    tok = first.argmax(-1)[:, None]
    torch.cuda.synchronize()
    steps = {
        "prefill": lambda: engine._prefill_impl(toks, lens),
        "decode_step": lambda: transformer.forward_with_cache(
            cfg, params, tok, cache),
    }
    for name, fn in steps.items():
        fn()
        torch.cuda.synchronize()
        emit("generate", step=f"profile_{name}", **profile_call(fn))


def profile_call(fn, top=12):
    """Device time by kernel of one call of fn, from torch.profiler
    (CUPTI), beside its wall time and its device time by CUDA events.

    On the H100 host a profile window now and then holds no device
    activity at all though its runtime calls are there (a decode window's
    cudaGraphLaunch and its results' cudaMemcpyAsync): 4 of 530 profiled
    engine steps in three probes (PR 17; PR 14 and PR 6 met the same),
    each with an "Activity Buffer Request" inside the window. The window
    opens on a kernel of its own (`torch.cuda._sleep`'s spin kernel; none
    of 300 steps opened on a kernel lost its trace), which the counts and
    times leave out. A trace that still holds no device time is reported
    as lost (`trace_lost`): device_ms, device_busy_share and launches
    None, no kinds, and `event_ms`, the CUDA events' span, which holds the
    device's idle gaps too. A call the events show no time for fails."""
    from torch.profiler import ProfilerActivity, profile

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1)
        start.record()
        t0 = time.perf_counter()
        fn()
        stop.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    event_ms = start.elapsed_time(stop)
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.self_device_time_total > 0 and "spin_kernel" not in e.key]
    device_us = sum(r[1] for r in rows)
    if device_us <= 0:
        if event_ms <= 0:
            raise SystemExit("profile: the call ran nothing on the device")
        return dict(wall_ms=wall * 1e3, device_ms=None,
                    device_busy_share=None, launches=None,
                    device_ms_by_kind={}, top=[], event_ms=event_ms,
                    trace_lost=True)
    rows.sort(key=lambda r: -r[1])
    kinds = {}
    for key, us, _ in rows:
        kind = kernel_kind(key)
        kinds[kind] = kinds.get(kind, 0.0) + us / 1e3
    return dict(wall_ms=wall * 1e3, device_ms=device_us / 1e3,
                device_busy_share=device_us / 1e3 / (wall * 1e3),
                event_ms=event_ms, trace_lost=False,
                launches=sum(r[2] for r in rows), device_ms_by_kind=kinds,
                top=[{"kernel": k[:80], "ms": us / 1e3, "count": n,
                      "share": us / device_us} for k, us, n in rows[:top]])


def over(ms, wall_ms):
    """A profiled device ms over a wall ms: None where the trace was
    lost."""
    return None if ms is None else ms / wall_ms


def kernel_kind(name):
    """A profiler kernel name's kind: one of the port's kernels, a GEMM
    (cuBLAS/CUTLASS), or other."""
    if any(b in name for b in ("decode_kernel", "decode_split",
                                "decode_wide")):
        # decode_core.cuh's body (PagedRows or DenseRows), the split-K
        # body or the wide ones (`decode_wide_mma`, `decode_wide_kernel`;
        # PagedTiles or DenseTiles); the int8 instances store `signed
        # char`.
        kind = ("paged_decode_attention" if "Paged" in name
                else "decode_attention_dense")
        return kind + ("_int8" if "signed char" in name else "")
    for key, kind in (("flash_fwd", "flash_attention_fwd"),
                      ("flash_bwd_dkdv", "flash_attention_bwd_dkdv"),
                      ("flash_bwd_dq", "flash_attention_bwd_dq"),
                      ("rms_norm", "rms_norm")):
        if key in name:
            return kind
    low = name.lower()
    if any(t in low for t in ("gemm", "xmma", "nvjet", "cutlass", "sm90_")):
        return "gemm"
    return "other"


# --------------------------------------------------------------------------
# serve: continuous batching over the paged pool
# --------------------------------------------------------------------------


def serve_requests(seed, vocab, n, prompt_range, new_range):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = int(rng.integers(prompt_range[0], prompt_range[1] + 1))
        out.append((f"r{i}", rng.integers(0, vocab, plen).astype(np.int32),
                    int(rng.integers(new_range[0], new_range[1] + 1))))
    return out


def warm_requests(seed, vocab):
    """Two requests at each prefill bucket length serve's prompts reach
    (16 to the bucket of PROMPT_HI), 16 new tokens each: a bucket's first
    prefill runs eagerly and its second captures its graph, so a timed
    run after them replays every prefill, as a warm server does."""
    rng = np.random.default_rng(seed)
    out, n = [], 16
    while True:
        for j in range(2):
            out.append((f"w{n}-{j}", rng.integers(0, vocab, n)
                        .astype(np.int32), NEW_LO))
        if n >= PROMPT_HI:
            return out
        n *= 2


def pct(xs, q):
    return float(np.percentile(np.asarray(xs, np.float64), q))


def step_totals(reg):
    """(sum, count) of the engine's per-step histograms in `reg`."""
    from shellac_tpu_torch.obs import STEP_PHASES

    out = {}
    for ph in STEP_PHASES:
        h = reg.get("shellac_step_phase_seconds", phase=ph)
        out[ph] = (h.sum, h.count) if h is not None else (0.0, 0)
    for name in ("shellac_decode_host_overhead_seconds",
                 "shellac_decode_window_seconds"):
        h = reg.get(name)
        out[name] = (h.sum, h.count) if h is not None else (0.0, 0)
    return out


def step_breakdown(before, after, wall):
    """Per engine step of a timed run, from the engine's own histograms:
    ms in each step phase (their sum is the step's wall), the host
    overhead and window wall per decode window, and the wall outside the
    engine's steps (the serving loop around them)."""
    from shellac_tpu_torch.obs import STEP_PHASES

    d = {k: (after[k][0] - before[k][0], after[k][1] - before[k][1])
         for k in after}
    steps = d["host_bookkeeping"][1]
    inside = sum(d[ph][0] for ph in STEP_PHASES)
    out = {"steps_observed": steps,
           "phase_ms_per_step": {ph: 1e3 * d[ph][0] / max(steps, 1)
                                 for ph in STEP_PHASES},
           "step_ms_mean": 1e3 * inside / max(steps, 1),
           "outside_steps_ms_per_step": 1e3 * (wall - inside)
           / max(steps, 1)}
    for name, key in (("shellac_decode_host_overhead_seconds",
                       "host_overhead_ms_per_window"),
                      ("shellac_decode_window_seconds",
                       "window_wall_ms_mean")):
        out[key] = 1e3 * d[name][0] / max(d[name][1], 1)
    return out


def pristine(engine):
    """The allocator after a drain: every block but scratch free, every
    table row and slot length 0."""
    be = engine.cache_backend
    return (len(be._free) == be.n_blocks - 1
            and all(not b for b in be._slot_blocks)
            and int(engine._cache.tables.abs().sum().item()) == 0
            and int(engine._cache.lengths.abs().sum().item()) == 0)


def pool_bytes(cache):
    return sum(t.numel() * t.element_size()
               for t in (cache.k, cache.v, getattr(cache, "ks", None),
                         getattr(cache, "vs", None)) if t is not None)


def phase_serve(seed, dev, table, card, backend="paged"):
    """The serve workload over `backend`: "paged" (16-token blocks in
    bf16, kernel 7) or "paged-int8" (64-token int8 blocks, kernel 7's
    int8 branch); the phase is named "serve" or "serve-int8"."""
    from shellac_tpu_torch import get_model_config
    from shellac_tpu_torch.inference.batching import PagedBatchingEngine
    from shellac_tpu_torch.models import transformer
    from shellac_tpu_torch.obs import Registry

    quant = backend == "paged-int8"
    phase = "serve-int8" if quant else "serve"
    block = BLOCK_INT8 if quant else BLOCK
    decode_kernel = ("paged_decode_attention_int8" if quant
                     else "paged_decode_attention")
    cfg = get_model_config("shellac-1b")
    params = transformer.init_params(cfg, seed=seed, device=dev)
    reg = Registry()
    engine = PagedBatchingEngine(
        cfg, params, n_slots=SLOTS, max_len=MAX_LEN, block_size=block,
        cache_backend=backend, decode_ticks=1, temperature=0.0, device=dev,
        registry=reg)
    be = engine.cache_backend
    reqs = serve_requests(seed + 1, cfg.vocab_size, REQUESTS,
                          (PROMPT_LO, PROMPT_HI), (NEW_LO, NEW_HI))
    # Warm-up (cuBLAS, the allocator, every graph), not counted.
    engine.run(warm_requests(seed + 2, cfg.vocab_size))
    torch.cuda.synchronize()
    reset_peak()
    be.peak_blocks_used = 0
    before = dict(engine.stats)
    totals0 = step_totals(reg)

    reset_counts(table)
    t0 = time.perf_counter()
    results = engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    breakdown = step_breakdown(totals0, step_totals(reg), wall)
    counts = read_counts(table)
    peak = torch.cuda.max_memory_allocated()
    delta = {k: engine.stats[k] - before[k] for k in
             ("prefills", "decode_windows", "pool_exhausted", "engine_steps",
              "requests_completed", "tokens_generated")}
    ticks = delta["decode_windows"] * engine.decode_ticks
    prefills = delta["prefills"]
    L = cfg.n_layers
    expect = expected_launches(table, L, delta, engine.decode_ticks,
                               decode_kernel)
    tokens_ok = (set(results) == {r[0] for r in reqs} and all(
        len(results[rid]) == m
        and all(0 <= t < cfg.vocab_size for t in results[rid])
        for rid, _, m in reqs))
    ttft, ttft_queued, tpot = [], [], []
    for rid, _, m in reqs:
        queued, admitted, first, done = engine.finished_timings[rid]
        ttft.append(first - admitted)
        ttft_queued.append(first - queued)
        tpot.append((done - first) / max(m - 1, 1))
    generated = sum(len(v) for v in results.values())
    summary = {"tokens_per_s": generated / wall,
               "ttft_ms_p50": pct(ttft, 50) * 1e3,
               "ttft_ms_p99": pct(ttft, 99) * 1e3,
               "ttft_queued_ms_p50": pct(ttft_queued, 50) * 1e3,
               "ttft_queued_ms_p99": pct(ttft_queued, 99) * 1e3,
               "tpot_ms_p50": pct(tpot, 50) * 1e3,
               "tpot_ms_p99": pct(tpot, 99) * 1e3,
               "engine_steps": delta["engine_steps"],
               "max_memory_allocated": peak,
               "step_breakdown": breakdown}
    clean = pristine(engine)
    # The same pool in bf16: k and v of (L, n_blocks, Hkv, bs, D).
    bf16_bytes = (2 * L * be.n_blocks * cfg.kv_heads * block
                  * cfg.dim_per_head * 2)
    emit(phase, step="main_path", model="shellac-1b", backend=be.name,
         slots=SLOTS, max_len=MAX_LEN, block_size=block,
         pool_blocks=be.n_blocks - 1, pool_bytes=pool_bytes(engine._cache),
         bf16_pool_bytes_same_tokens=bf16_bytes,
         bytes_per_token=be.bytes_per_token(),
         requests=len(reqs), generated_tokens=generated, wall_s=wall,
         tokens_per_s=generated / wall,
         ttft_ms_p50=pct(ttft, 50) * 1e3, ttft_ms_p99=pct(ttft, 99) * 1e3,
         ttft_ms=[t * 1e3 for t in ttft],
         ttft_queued_ms_p50=summary["ttft_queued_ms_p50"],
         ttft_queued_ms_p99=summary["ttft_queued_ms_p99"],
         step_breakdown=breakdown,
         tpot_ms_p50=pct(tpot, 50) * 1e3, tpot_ms_p99=pct(tpot, 99) * 1e3,
         engine_steps=delta["engine_steps"], decode_ticks=ticks,
         prefills=prefills, pool_exhausted_requeues=delta["pool_exhausted"],
         peak_pool_utilization=be.peak_blocks_used / (be.n_blocks - 1),
         max_memory_allocated=peak, launches=counts, expected=expect,
         graphs_captured=engine.stats["decode_graphs"],
         tokens_ok=tokens_ok, allocator_pristine=clean, card=card)
    if counts != expect or not tokens_ok or not clean:
        raise SystemExit(f"{phase}: wrong launch counts, bad tokens or a "
                         "leaked block")

    # One engine step profiled: 16 slots decoding, no admission; then
    # decode-only steps timed on the host, through the graph and, on an
    # engine whose windows run eagerly, without it.
    full = serve_requests(seed + 3, cfg.vocab_size, SLOTS,
                          (PROMPT_HI // 2, PROMPT_HI // 2),
                          (NEW_HI // 2, NEW_HI // 2))
    for rid, toks, m in full:
        engine.submit(rid, toks, m)
    engine.step()
    engine.step()
    torch.cuda.synchronize()
    graph_ttft = admission_ms(engine)
    prof = profile_call(engine.step)
    emit(phase, step="profile_engine_step", active_slots=sum(
        r is not None for r in engine._slots), **prof)
    graph_walls = decode_step_walls(engine)
    eager = eager_engine(PagedBatchingEngine)(
        cfg, params, n_slots=SLOTS, max_len=MAX_LEN, block_size=block,
        cache_backend=backend, decode_ticks=1, temperature=0.0, device=dev)
    for rid, toks, m in full:
        eager.submit(rid, toks, m)
    eager.step()
    eager.step()
    eager_ttft = admission_ms(eager)
    eager_walls = decode_step_walls(eager)
    eager.abort_all()
    del eager
    summary["wall_ms_per_tick_p50"] = float(np.median(graph_walls))
    summary["device_busy_share"] = over(prof["device_ms"],
                                        float(np.median(graph_walls)))
    summary["trace_lost"] = prof["trace_lost"]
    summary["decode_graphs"] = engine.stats["decode_graphs"]
    summary["prefill_graphs"] = prefill_graphs(engine)
    emit(phase, step="decode_tick_wall", active_slots=SLOTS,
         graph_ms_per_tick=graph_walls, eager_ms_per_tick=eager_walls,
         graph_over_eager=float(np.median(graph_walls)
                                / np.median(eager_walls)),
         graphs_captured=engine.stats["decode_graphs"],
         ttft_ms_16_admissions_graph=graph_ttft,
         ttft_ms_16_admissions_eager=eager_ttft,
         # The profiled step's device ms over an unprofiled step's wall
         # ms (the profiler's own host cost inflates its wall time).
         device_busy_share=over(prof["device_ms"],
                                float(np.median(graph_walls))),
         profiled_device_busy_share=prof["device_busy_share"],
         trace_lost=prof["trace_lost"], card=card)
    check_decode_logits(phase, cfg, params, engine)
    engine.abort_all()
    if not pristine(engine):
        raise SystemExit(f"{phase}: abort_all left blocks allocated")
    del engine, params
    torch.cuda.empty_cache()
    return counts, {"results": results, "summary": summary}


def admission_ms(engine):
    """Each running request's time to first token on the host (its
    admission to its prefill's first token), ms, slot by slot."""
    return [(r.t_first - r.t_admitted) * 1e3 for r in engine._slots if r]


def decode_step_walls(engine, steps=20):
    """Host wall ms of each of `steps` engine steps that only decode (no
    slot frees or fills), each ending in the window's host sync."""
    walls = []
    for _ in range(steps):
        t0 = time.perf_counter()
        done = engine.step()
        walls.append((time.perf_counter() - t0) * 1e3)
        if done or engine._queue:
            raise SystemExit("decode_step_walls: a step admitted or freed")
    return walls


def check_decode_logits(phase, cfg, params, engine):
    """One decode step's logits of the engine's model through the paged
    kernel (bf16 or int8) against attn_impl="ref" on the same cache
    state, on the active slots: within 5e-2 of the plain logits' scale,
    as generate's prefill check. Each call writes its own k/v row at
    each slot's length, which the next real step overwrites; the
    engine's lengths do not move."""
    from shellac_tpu_torch.models import transformer

    act = [i for i, r in enumerate(engine._slots) if r is not None]
    logits = {}
    with torch.inference_mode():
        for impl in ("auto", "ref"):
            logits[impl], _ = transformer.forward_with_cache(
                cfg, params, engine._cur[:, None], engine._cache,
                attn_impl=impl)
    got, ref = logits["auto"][act, 0], logits["ref"][act, 0]
    scale = ref.abs().max().item()
    err = (got - ref).abs().max().item()
    ok = (len(act) > 0 and bool(torch.isfinite(got).all().item())
          and err <= 5e-2 * scale)
    agree = int((got.argmax(-1) == ref.argmax(-1)).sum().item())
    emit(phase, step="decode_logits_kernel_vs_ref", active_slots=len(act),
         shape=list(got.shape), max_abs_err=err, ref_max_abs=scale,
         tol="max_abs_err <= 5e-2 * max|ref|", argmax_agree=agree, ok=ok)
    if not ok:
        raise SystemExit(f"{phase}: decode logits through the paged kernel "
                         "disagree with the plain path")


# The chunked pass of serve-overlap parts from serve's tokens only where
# the plain model's top-2 logit margin is below this: its continuation
# chunks attend through the plain bf16 attention (as the reference pins
# them), not kernel 2, so logits move by rounding.
CHUNK = 256
CHUNK_MARGIN = 0.5


def fill_decoding(engine, reqs):
    """Submit `reqs` and step until every one of them decodes: admitted,
    prefilled and settled (one prefill a step under the serve cap)."""
    for rid, toks, m in reqs:
        engine.submit(rid, toks, m)
    steps = 0
    while (engine._queue or engine._pflights or engine._prefilling
           or any(r is not None and not r.out for r in engine._slots)):
        engine.step()
        steps += 1
    engine.step()
    return steps + 1


def phase_serve_overlap(seed, dev, table, card, ref):
    """serve's workload with the reference `serve`'s scheduling: both
    overlap pipelines and one prefill an engine step (PIPELINED), the
    prefills and windows as graph replays. Every sequence must equal the
    serve phase's strict run; tokens/s, TTFT, TPOT, wall per tick, the
    device-busy share, peak memory and the graphs captured are printed
    beside serve's. A second pass at prefill_chunk=CHUNK holds its
    tokens to serve's where the plain model's top-2 margin allows."""
    from shellac_tpu_torch import get_model_config
    from shellac_tpu_torch.inference.batching import PagedBatchingEngine
    from shellac_tpu_torch.models import transformer
    from shellac_tpu_torch.obs import Registry

    cfg = get_model_config("shellac-1b")
    params = transformer.init_params(cfg, seed=seed, device=dev)
    reg = Registry()
    engine = PagedBatchingEngine(
        cfg, params, n_slots=SLOTS, max_len=MAX_LEN, block_size=BLOCK,
        cache_backend="paged", decode_ticks=1, temperature=0.0, device=dev,
        registry=reg, **PIPELINED)
    reqs = serve_requests(seed + 1, cfg.vocab_size, REQUESTS,
                          (PROMPT_LO, PROMPT_HI), (NEW_LO, NEW_HI))
    # Warm-up, not counted: the window graph and every bucket's prefill
    # graph are captured.
    engine.run(warm_requests(seed + 2, cfg.vocab_size))
    torch.cuda.synchronize()
    reset_peak()
    before = dict(engine.stats)
    totals0 = step_totals(reg)
    reset_counts(table)
    t0 = time.perf_counter()
    results = engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = read_counts(table)
    breakdown = step_breakdown(totals0, step_totals(reg), wall)
    delta = {k: engine.stats[k] - before[k] for k in
             ("prefills", "decode_windows", "engine_steps")}
    expect = expected_launches(table, cfg.n_layers, delta, 1,
                               "paged_decode_attention")
    equal = results == ref["results"]
    ttft, ttft_queued, tpot = [], [], []
    for rid, _, m in reqs:
        queued, admitted, first, done = engine.finished_timings[rid]
        ttft.append(first - admitted)
        ttft_queued.append(first - queued)
        tpot.append((done - first) / max(m - 1, 1))
    generated = sum(len(v) for v in results.values())
    # Decode-only steps: 16 slots decoding, no admission.
    full = serve_requests(seed + 3, cfg.vocab_size, SLOTS,
                          (PROMPT_HI // 2, PROMPT_HI // 2),
                          (NEW_HI // 2, NEW_HI // 2))
    fill_steps = fill_decoding(engine, full)
    walls = decode_step_walls(engine)
    prof = profile_call(engine.step)
    engine.abort_all()
    clean = pristine(engine)
    graphs = {"decode": engine.stats["decode_graphs"],
              "prefill": prefill_graphs(engine)}
    serve = ref["summary"]
    emit("serve-overlap", step="main_path", model="shellac-1b",
         slots=SLOTS, max_len=MAX_LEN, block_size=BLOCK, **PIPELINED,
         requests=len(reqs), generated_tokens=generated, wall_s=wall,
         tokens_equal_to_serve=equal, tokens_per_s=generated / wall,
         ttft_ms_p50=pct(ttft, 50) * 1e3, ttft_ms_p99=pct(ttft, 99) * 1e3,
         ttft_queued_ms_p50=pct(ttft_queued, 50) * 1e3,
         ttft_queued_ms_p99=pct(ttft_queued, 99) * 1e3,
         tpot_ms_p50=pct(tpot, 50) * 1e3, tpot_ms_p99=pct(tpot, 99) * 1e3,
         wall_ms_per_tick=walls,
         wall_ms_per_tick_p50=float(np.median(walls)),
         device_ms_per_step=prof["device_ms"],
         device_busy_share=over(prof["device_ms"], float(np.median(walls))),
         profiled_device_busy_share=prof["device_busy_share"],
         trace_lost=prof["trace_lost"],
         max_memory_allocated=peak, graphs_captured=graphs,
         steps_to_fill_16_slots=fill_steps, step_breakdown=breakdown,
         engine_steps=delta["engine_steps"], prefills=delta["prefills"],
         decode_windows=delta["decode_windows"], launches=counts,
         expected=expect, allocator_pristine=clean,
         serve={k: serve.get(k) for k in (
             "tokens_per_s", "ttft_ms_p50", "ttft_ms_p99",
             "ttft_queued_ms_p50", "ttft_queued_ms_p99", "tpot_ms_p50",
             "tpot_ms_p99", "wall_ms_per_tick_p50", "device_busy_share",
             "max_memory_allocated", "decode_graphs", "prefill_graphs")},
         card=card)
    if not equal or counts != expect or not clean or graphs["prefill"] < 1:
        raise SystemExit("serve-overlap: tokens differ from serve's, launch "
                         "counts are off, a block leaked or no prefill ran "
                         "as a graph")

    # The chunked pass: the same engine at prefill_chunk=CHUNK.
    engine.set_prefill_chunk(CHUNK)
    before = dict(engine.stats)
    t0 = time.perf_counter()
    chunked = engine.run(reqs)
    torch.cuda.synchronize()
    chunk_wall = time.perf_counter() - t0
    prompts = {rid: toks for rid, toks, _ in reqs}
    mismatches = []
    for rid, want in ref["results"].items():
        got = chunked.get(rid)
        if got == want:
            continue
        pos = next((j for j, (a, b) in enumerate(zip(got or [], want))
                    if a != b), min(len(got or []), len(want)))
        mismatches.append({"rid": rid, "first_diff": pos,
                           "prompt_len": int(prompts[rid].size),
                           "ref_top2_margin": top2_margin(
                               cfg, params, dev, prompts[rid], want[:pos])})
    worst = max((m["ref_top2_margin"] for m in mismatches), default=0.0)
    chunks = engine.stats["prefill_chunks"] - before["prefill_chunks"]
    emit("serve-overlap", step="chunked", prefill_chunk=CHUNK,
         prefill_chunks=chunks, wall_s=chunk_wall,
         tokens_per_s=sum(len(v) for v in chunked.values()) / chunk_wall,
         sequences_equal=len(reqs) - len(mismatches), requests=len(reqs),
         mismatches=mismatches, margin_tol=CHUNK_MARGIN, card=card)
    engine.abort_all()
    engine.close()
    del engine, params
    reset_peak()
    if chunks < 1 or worst >= CHUNK_MARGIN or set(chunked) != set(results):
        raise SystemExit("serve-overlap: the chunked pass ran no chunk or "
                         "parts from serve's tokens where the plain "
                         "model's top-2 margin is wide")
    return counts


def phase_serve_parity(seed, dev):
    """Greedy tokens of the paged engine through the kernels, the same
    engine on the plain attention, and the dense engine (kernel 5) must be
    identical, in fp32 at shellac-1b width cut to 2 layers; so must the
    dense and paged engines with chunked prefill (64-token chunks; their
    continuations attend through the plain attention, as the reference
    pins them) under the reference serve's scheduling."""
    from shellac_tpu_torch import get_model_config
    from shellac_tpu_torch.inference.batching import (
        BatchingEngine,
        PagedBatchingEngine,
    )
    from shellac_tpu_torch.models import transformer

    cfg = get_model_config("shellac-1b").replace(n_layers=2, dtype="float32")
    params = transformer.init_params(cfg, seed=seed, device=dev)
    reqs = serve_requests(seed + 4, cfg.vocab_size, 14, (16, 300), (4, 24))
    runs = {
        "paged_kernel": PagedBatchingEngine(cfg, params, n_slots=6,
                                            max_len=512, device=dev),
        "paged_ref": PagedBatchingEngine(cfg, params, n_slots=6, max_len=512,
                                         attn_impl="ref", device=dev),
        "dense_kernel": BatchingEngine(cfg, params, n_slots=6, max_len=512,
                                       device=dev),
        "paged_kernel_chunked": PagedBatchingEngine(
            cfg, params, n_slots=6, max_len=512, prefill_chunk=64,
            device=dev, **PIPELINED),
        "dense_kernel_chunked": BatchingEngine(
            cfg, params, n_slots=6, max_len=512, prefill_chunk=64,
            device=dev, **PIPELINED),
    }
    out = {name: eng.run(reqs) for name, eng in runs.items()}
    equal = all(o == out["paged_ref"] for o in out.values())
    chunks = {name: runs[name].stats["prefill_chunks"]
              for name in ("paged_kernel_chunked", "dense_kernel_chunked")}
    emit("serve-parity", requests=len(reqs), slots=6, dtype="float32",
         layers=2, tokens=sum(len(v) for v in out["paged_kernel"].values()),
         prefill_chunks=chunks,
         identical={name: o == out["paged_ref"] for name, o in out.items()})
    equal = equal and min(chunks.values()) > 0
    if not equal:
        raise SystemExit("serve-parity: greedy tokens differ")
    del runs, params
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# the HTTP server (http-serve) and the serve command line (cli-serve)
# --------------------------------------------------------------------------

# The http-serve requests by index: 4 of every 6 to /generate, 1 streamed,
# 1 to /v1/completions (32, 8 and 8 of serve's 48).
HTTP_KINDS = ("generate",) * 4 + ("stream", "completions")
HTTP_CLIENTS = 16


def http_call(base, path, payload=None, timeout=600, stream=False):
    """POST (or GET without a payload) over urllib: (status, headers,
    body bytes, seconds to the first body line). HTTP errors return."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        base + path, data=data,
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    first = None
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            if not stream:
                return r.status, r.headers, r.read(), None
            lines = []
            for raw in r:
                if first is None:
                    first = time.perf_counter() - t0
                lines.append(raw)
            return r.status, r.headers, b"".join(lines), first
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read(), first


def hist_quantile(text, name, q):
    """The q-quantile of histogram `name` in Prometheus text, interpolated
    within its bucket (the estimate a scraper makes)."""
    pairs = []
    for line in text.splitlines():
        if line.startswith(name + "_bucket{"):
            le = line.split('le="')[1].split('"')[0]
            pairs.append((float(le), float(line.rsplit(" ", 1)[1])))
    if not pairs or pairs[-1][1] == 0:
        return None
    target = q * pairs[-1][1]
    lo, below = 0.0, 0.0
    for le, cum in pairs:
        if cum >= target:
            if le == float("inf"):
                return lo
            return lo + (le - lo) * (target - below) / max(cum - below, 1)
        lo, below = le, cum
    return lo


def metric_value(text, series):
    for line in text.splitlines():
        if line.startswith(series + " "):
            return float(line.rsplit(" ", 1)[1])
    return None


def top2_margin(cfg, params, dev, prompt, prefix):
    """The plain model's top-2 logit margin after prompt + prefix: how
    close the reference's greedy choice was where two runs part."""
    from shellac_tpu_torch.models import transformer

    toks = torch.tensor([list(map(int, prompt)) + list(prefix)],
                        dtype=torch.int64, device=dev)
    with torch.inference_mode():
        last = transformer.forward(cfg, params, toks, device=dev)[0, -1]
    top = torch.topk(last.float(), 2).values
    return float(top[0] - top[1])


def phase_http_serve(seed, dev, table, card, ref):
    """serve's 48 requests over HTTP: InferenceServer over the serve
    phase's engine configuration with the reference `serve`'s scheduling
    (PIPELINED: both pipelines, one prefill a step),
    make_http_server on 127.0.0.1:0, 16 client threads (32 /generate, 8
    streamed, 8 /v1/completions with token prompts). Every token
    sequence must equal the serve phase's."""
    import queue as queue_mod
    import threading

    from shellac_tpu_torch import get_model_config
    from shellac_tpu_torch.inference.batching import PagedBatchingEngine
    from shellac_tpu_torch.inference.server import (
        InferenceServer,
        make_http_server,
    )
    from shellac_tpu_torch.models import transformer
    from shellac_tpu_torch.obs import FlightRecorder, Registry

    cfg = get_model_config("shellac-1b")
    params = transformer.init_params(cfg, seed=seed, device=dev)
    reg = Registry()
    engine = PagedBatchingEngine(
        cfg, params, n_slots=SLOTS, max_len=MAX_LEN, block_size=BLOCK,
        cache_backend="paged", decode_ticks=1, temperature=0.0, device=dev,
        registry=reg, **PIPELINED)
    # A ring that holds every request's timeline (the default 2048
    # events would evict the early ones).
    srv = InferenceServer(cfg, params, engine=engine, registry=reg,
                          model_name="shellac-1b",
                          recorder=FlightRecorder(capacity=1 << 16,
                                                  registry=reg))
    httpd = make_http_server(srv, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    reqs = serve_requests(seed + 1, cfg.vocab_size, REQUESTS,
                          (PROMPT_LO, PROMPT_HI), (NEW_LO, NEW_HI))
    # Warm-up through HTTP, as serve warms its engine: the scheduler
    # thread runs the first eager window and prefills and captures the
    # graphs.
    warm = warm_requests(seed + 2, cfg.vocab_size)
    for _, toks, m in warm:
        status, _, body, _ = http_call(base, "/generate",
                                       {"tokens": toks.tolist(),
                                        "max_new": m})
        if status != 200:
            raise SystemExit(f"http-serve: warm-up answered {status}: {body}")
    torch.cuda.synchronize()
    before = dict(engine.stats)
    totals0 = step_totals(reg)
    jobs = queue_mod.Queue()
    for i, r in enumerate(reqs):
        jobs.put((i, *r))
    out = {}

    def client():
        while True:
            try:
                i, rid, toks, m = jobs.get_nowait()
            except queue_mod.Empty:
                return
            kind = HTTP_KINDS[i % len(HTTP_KINDS)]
            t0 = time.perf_counter()
            if kind == "completions":
                status, hdr, body, first = http_call(
                    base, "/v1/completions",
                    {"prompt": toks.tolist(), "max_tokens": m,
                     "temperature": 0})
            else:
                status, hdr, body, first = http_call(
                    base, "/generate",
                    {"tokens": toks.tolist(), "max_new": m,
                     "stream": kind == "stream"}, stream=kind == "stream")
            wall = time.perf_counter() - t0
            tokens = None
            if status == 200:
                if kind == "stream":
                    recs = [json.loads(ln) for ln in body.splitlines()]
                    tokens = (recs[-1]["tokens"] if recs[-1].get("done")
                              else None)
                elif kind == "completions":
                    # No tokenizer: the text is the token list itself.
                    tokens = json.loads(
                        json.loads(body)["choices"][0]["text"])
                else:
                    tokens = json.loads(body)["tokens"]
            out[rid] = {"kind": kind, "status": status, "tokens": tokens,
                        "wall_s": wall, "first_s": first,
                        "trace_id": hdr.get("x-request-id")}

    reset_counts(table)
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client) for _ in range(HTTP_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    counts = read_counts(table)
    breakdown = step_breakdown(totals0, step_totals(reg), wall)
    delta = {k: engine.stats[k] - before[k] for k in
             ("prefills", "decode_windows", "requests_completed",
              "tokens_generated")}
    ticks = delta["decode_windows"] * engine.decode_ticks
    expect = expected_launches(table, cfg.n_layers, delta,
                               engine.decode_ticks, "paged_decode_attention")
    statuses = sorted({o["status"] for o in out.values()})
    mismatches = []
    for rid, toks, m in reqs:
        want = ref["results"][rid]
        got = out.get(rid, {}).get("tokens")
        if got != want:
            pos = next((j for j, (a, b) in enumerate(zip(got or [], want))
                        if a != b), min(len(got or []), len(want)))
            mismatches.append({"rid": rid, "kind": out.get(rid, {}).get(
                "kind"), "prompt_len": int(toks.size), "max_new": m,
                "first_diff": pos, "got": got, "want": want})
    # Server-side numbers: /stats digests, /metrics, and each request's
    # exact clocks from its flight-recorder timeline.
    _, _, stats_body, _ = http_call(base, "/stats")
    stats = json.loads(stats_body)
    health_status, _, _, _ = http_call(base, "/health")
    _, _, metrics_body, _ = http_call(base, "/metrics")
    text = metrics_body.decode()
    answered = len(reqs) + len(warm)
    ok_count = metric_value(
        text, 'shellac_requests_total{outcome="ok",tenant=""}')
    ttft_count = metric_value(text, "shellac_ttft_seconds_count")
    server = {"ttft": [], "queue_wait": [], "e2e": [], "tpot": []}
    for o in out.values():
        _, _, body, _ = http_call(base, f"/debug/request/{o['trace_id']}")
        ev = {e["event"]: e for e in json.loads(body)["events"]}
        ttft, e2e = ev["first-token"]["ttft_s"], ev["finish"]["e2e_s"]
        n = ev["finish"]["n_tokens"]
        server["ttft"].append(ttft)
        server["queue_wait"].append(ev["prefill"]["queue_wait_s"])
        server["e2e"].append(e2e)
        server["tpot"].append((e2e - ttft) / max(n - 1, 1))
    clean = pristine(engine)
    graphs = {"decode": engine.stats["decode_graphs"],
              "prefill": prefill_graphs(engine)}
    srv.close()
    httpd.shutdown()
    httpd.server_close()
    exited = not srv._thread.is_alive()
    for mm in mismatches:
        if mm["got"]:
            mm["ref_top2_margin"] = top2_margin(
                cfg, params, dev, dict((r[0], r[1]) for r in reqs)[mm["rid"]],
                mm["want"][:mm["first_diff"]])
        emit("http-serve", step="token_mismatch", **mm)
    generated = sum(len(ref["results"][r[0]]) for r in reqs)
    stream_first = [o["first_s"] for o in out.values()
                    if o["kind"] == "stream" and o["first_s"] is not None]
    walls = [o["wall_s"] for o in out.values()]

    def p50_99(xs):
        return {"p50": pct(xs, 50) * 1e3, "p99": pct(xs, 99) * 1e3}

    emit("http-serve", step="main_path", model="shellac-1b", slots=SLOTS,
         max_len=MAX_LEN, block_size=BLOCK, clients=HTTP_CLIENTS, **PIPELINED,
         requests={k: sum(o["kind"] == k for o in out.values())
                   for k in ("generate", "stream", "completions")},
         statuses=statuses, tokens_equal_to_serve=not mismatches,
         generated_tokens=generated, wall_s=wall,
         tokens_per_s=generated / wall,
         client_ttft_ms_stream=p50_99(stream_first),
         client_wall_ms=p50_99(walls),
         server_ttft_ms=p50_99(server["ttft"]),
         server_queue_wait_ms=p50_99(server["queue_wait"]),
         server_tpot_ms=p50_99(server["tpot"]),
         server_e2e_ms=p50_99(server["e2e"]),
         stats_ttft_s=stats["ttft_s"], stats_queue_wait_s=stats["queue_wait_s"],
         metrics_tpot_s={"p50": hist_quantile(text, "shellac_tpot_seconds",
                                              0.5),
                         "p99": hist_quantile(text, "shellac_tpot_seconds",
                                              0.99)},
         step_breakdown=breakdown, in_process_serve=ref["summary"],
         http_over_in_process_tokens_per_s=(generated / wall)
         / ref["summary"]["tokens_per_s"],
         metrics_ok_requests=ok_count, metrics_ttft_count=ttft_count,
         answered=answered, health=health_status, scheduler_exited=exited,
         allocator_pristine=clean, engine_steps=engine.stats["engine_steps"]
         - before["engine_steps"], decode_ticks=ticks,
         prefills=delta["prefills"], launches=counts, expected=expect,
         graphs_captured=graphs, card=card)
    if (statuses != [200] or mismatches or counts != expect
            or ok_count != answered or ttft_count != answered
            or health_status != 200 or not exited or not clean):
        raise SystemExit("http-serve: a request failed, tokens differ from "
                         "serve's, launch counts or /metrics are off, or "
                         "the scheduler did not exit")
    del engine, srv, params
    reset_peak()
    return counts


# cli-serve's chat check: the chat route returns text, and the byte
# tokenizer decodes no id past 255, so the answer's ids are held through
# their logprobs. The same kernels at the same shapes give the same
# logits, so they are expected equal; a different id at any position
# changes that position's logprob (unless two logits tie within the
# tolerance) and the context of every later one.
CHAT_LOGPROB_TOL = 1e-4


def phase_cli_serve(seed, dev, card):
    """`python -m shellac_tpu_torch serve` in a subprocess: shellac-1b cut
    to 2 layers by a --config file, the paged backend, 4 slots, port 0,
    `--logprobs`, and the CLI's serving defaults (both overlap
    pipelines, `--decode-ticks auto`: the startup sweep runs before the
    serving line; one prefill a step). Four requests (two blocking, one
    streamed, one chat) must give the tokens of an in-process strict
    PagedBatchingEngine on the same config and seed (the chat's through
    its text, its token count and its per-token logprobs within
    CHAT_LOGPROB_TOL), /stats must show the tuned decode_ticks and both
    pipelines on, and SIGINT must stop it with exit code 0."""
    import os
    import queue as queue_mod
    import signal
    import tempfile
    import threading

    from shellac_tpu_torch import get_model_config
    from shellac_tpu_torch.inference.batching import PagedBatchingEngine
    from shellac_tpu_torch.inference.openai_api import render_chat
    from shellac_tpu_torch.models import transformer
    from shellac_tpu_torch.training.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    rng = np.random.default_rng(seed + 5)
    cfg = get_model_config("shellac-1b").replace(n_layers=2)
    prompts = [("a", rng.integers(0, cfg.vocab_size, 40), 24),
               ("b", rng.integers(0, cfg.vocab_size, 200), 16),
               ("s", rng.integers(0, cfg.vocab_size, 90), 20)]
    msgs = [{"role": "user", "content": "Say something about kernels."}]
    chat_ids = tok.encode(render_chat(msgs, tok))
    with tempfile.TemporaryDirectory() as tmp:
        conf = os.path.join(tmp, "cfg.json")
        with open(conf, "w") as f:
            json.dump({"preset": "shellac-1b", "n_layers": 2}, f)
        cmd = [sys.executable, "-m", "shellac_tpu_torch", "serve", "--config",
               conf, "--cache-backend", "paged", "--slots", "4", "--port",
               "0", "--seed", str(seed), "--logprobs"]
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        lines, errs = queue_mod.Queue(), []
        threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout],
                         daemon=True).start()
        threading.Thread(target=lambda: errs.extend(proc.stderr),
                         daemon=True).start()
        try:
            base, deadline = None, time.monotonic() + 300
            while base is None:
                if proc.poll() is not None or time.monotonic() > deadline:
                    raise SystemExit(
                        f"cli-serve: no serving line (exit {proc.poll()}): "
                        + "".join(errs)[-4000:])
                try:
                    base = json.loads(lines.get(timeout=1))["serving"]
                except (queue_mod.Empty, ValueError, KeyError):
                    continue
            up_s = time.perf_counter() - t0
            got = {}

            def post(rid, path, payload, stream=False):
                status, _, body, _ = http_call(base, path, payload,
                                               stream=stream)
                got[rid] = (status, body)

            calls = [threading.Thread(target=post, args=(
                rid, "/generate", {"tokens": toks.tolist(), "max_new": m,
                                   "stream": rid == "s"}, rid == "s"))
                for rid, toks, m in prompts]
            calls.append(threading.Thread(target=post, args=(
                "c", "/v1/chat/completions",
                {"messages": msgs, "max_tokens": 12, "logprobs": True})))
            for t in calls:
                t.start()
            for t in calls:
                t.join(timeout=300)
            _, _, stats_body, _ = http_call(base, "/stats")
            stats = json.loads(stats_body)
            proc.send_signal(signal.SIGINT)
            t1 = time.perf_counter()
            rc = proc.wait(timeout=120)
            stop_s = time.perf_counter() - t1
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    params = transformer.init_params(cfg, seed=seed, device=dev)
    engine = PagedBatchingEngine(cfg, params, n_slots=4,
                                 max_len=cfg.max_seq_len, decode_ticks=1,
                                 temperature=0.0, logprobs=True, device=dev)
    want = engine.run([(rid, toks.astype(np.int32), m)
                       for rid, toks, m in prompts]
                      + [("c", chat_ids, 12)])
    ok = {}
    for rid, _, _ in prompts:
        status, body = got.get(rid, (None, b""))
        if status == 200:
            rec = (json.loads(body.splitlines()[-1]) if rid == "s"
                   else json.loads(body))
            ok[rid] = rec["tokens"] == want[rid]
        else:
            ok[rid] = False
    status, body = got.get("c", (None, b""))
    chat = json.loads(body) if status == 200 else None
    want_lps = engine.finished_logprobs["c"]
    chat_lp_err = None
    if chat is not None:
        got_lps = [e["logprob"] for e in
                   chat["choices"][0]["logprobs"]["content"]]
        if len(got_lps) == len(want_lps):
            chat_lp_err = max(abs(a - b) for a, b in zip(got_lps, want_lps))
    ok["c"] = (chat is not None
               and chat["choices"][0]["message"]["content"]
               == tok.decode(want["c"])
               and chat["usage"]["completion_tokens"] == len(want["c"])
               and chat_lp_err is not None
               and chat_lp_err <= CHAT_LOGPROB_TOL)
    defaults = {k: stats.get(k) for k in (
        "decode_ticks", "decode_ticks_source", "overlap_decode",
        "overlap_prefill", "prefill_chunk_source")}
    ok["defaults"] = (defaults["decode_ticks_source"] == "auto-tuned"
                      and defaults["overlap_decode"] is True
                      and defaults["overlap_prefill"] is True)
    emit("cli-serve", command=" ".join(cmd[1:3] + ["serve", "--config",
                                                   "<tmp>"] + cmd[6:]),
         config={"preset": "shellac-1b", "n_layers": 2},
         seconds_to_serving=up_s, serving_defaults=defaults,
         statuses={r: s for r, (s, _) in got.items()},
         tokens_equal=ok, chat_logprob_max_abs_err=chat_lp_err,
         chat_logprob_tol=CHAT_LOGPROB_TOL, exit_code=rc,
         seconds_to_exit=stop_s,
         stderr_tail="".join(errs)[-2000:], card=card)
    del engine, params
    reset_peak()
    if not all(ok.values()) or rc != 0:
        raise SystemExit("cli-serve: tokens differ from the in-process "
                         "engine, the serving defaults are not the "
                         "reference's, or the server did not exit 0 on "
                         "SIGINT")


def phase_serve_parity_int8(seed, dev, table):
    """The int8 engines through the kernels against the paged-int8 engine
    on the plain attention, in fp32 at shellac-1b width cut to 2 layers:
    logprobs within 1e-3 and the same greedy tokens while the plain run's
    top-2 logprob margin is at least 2e-3 (then summation order cannot
    swap the argmax)."""
    from shellac_tpu_torch import get_model_config
    from shellac_tpu_torch.inference.batching import (
        BatchingEngine,
        PagedBatchingEngine,
    )
    from shellac_tpu_torch.models import transformer

    tol = 1e-3
    cfg = get_model_config("shellac-1b").replace(n_layers=2, dtype="float32")
    params = transformer.init_params(cfg, seed=seed, device=dev)
    reqs = serve_requests(seed + 4, cfg.vocab_size, 14, (16, 300), (4, 24))
    kw = dict(n_slots=6, max_len=512, logprobs=True, top_logprobs=2,
              device=dev)
    runs = {
        "paged_int8_ref": PagedBatchingEngine(
            cfg, params, cache_backend="paged-int8", attn_impl="ref", **kw),
        "paged_int8_kernel": PagedBatchingEngine(
            cfg, params, cache_backend="paged-int8", **kw),
        "dense_int8_kernel": BatchingEngine(
            cfg, params, cache_backend="dense-int8", **kw),
    }
    reset_counts(table)
    out = {name: eng.run(reqs) for name, eng in runs.items()}
    counts = read_counts(table)
    ref = runs["paged_int8_ref"]
    report, ok = {}, counts["decode_attention_dense_int8"] > 0 \
        and counts["paged_decode_attention_int8"] > 0
    for name in ("paged_int8_kernel", "dense_int8_kernel"):
        eng, compared, lp_err = runs[name], 0, 0.0
        for rid, _, _ in reqs:
            margins = [lps[0] - lps[1]
                       for _, lps in ref.finished_top_logprobs[rid]]
            low = [i for i, m in enumerate(margins) if m < 2 * tol]
            upto = low[0] if low else len(margins)
            ok = ok and out[name][rid][:upto] == out["paged_int8_ref"][rid][
                :upto]
            lp_err = max([lp_err] + [
                abs(a - b) for a, b in zip(eng.finished_logprobs[rid][:upto],
                                           ref.finished_logprobs[rid][:upto])])
            compared += upto
        total = sum(len(v) for v in out[name].values())
        ok = ok and lp_err <= tol and compared >= 0.75 * total
        report[name] = dict(tokens_compared=compared, tokens=total,
                            logprob_max_abs_err=lp_err,
                            identical=out[name] == out["paged_int8_ref"])
    emit("serve-parity-int8", requests=len(reqs), slots=6, dtype="float32",
         layers=2, launches=counts, tol_logprob=tol, margin=2 * tol,
         ok=ok, **report)
    if not ok:
        raise SystemExit("serve-parity-int8: the int8 engines through the "
                         "kernels differ from the plain path")
    del runs, params
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# prefix-serve: the prefix cache; sampling-controls: the per-request controls
# --------------------------------------------------------------------------

# prefix-serve's traffic: one shared system prompt, distinct tails.
SYSTEM, TAIL_LO, TAIL_HI, PFX_NEW_LO, PFX_NEW_HI = 1024, 16, 256, 32, 128
# The eviction pass's pool: four system prompts do not fit beside the
# slots' own blocks.
EVICT_POOL = 6144


def prefix_requests(seed, vocab, n, systems=1, system_len=SYSTEM,
                    tails=(TAIL_LO, TAIL_HI), new=(PFX_NEW_LO, PFX_NEW_HI)):
    """n requests, request i on system prompt i % systems plus a tail of
    its own."""
    rng = np.random.default_rng(seed)
    heads = [rng.integers(0, vocab, system_len) for _ in range(systems)]
    out = []
    for i in range(n):
        tail = rng.integers(0, vocab, int(rng.integers(tails[0],
                                                       tails[1] + 1)))
        out.append((f"p{i}", np.concatenate([heads[i % systems], tail])
                    .astype(np.int32),
                    int(rng.integers(new[0], new[1] + 1))))
    return out


def prefix_warm_requests(seed, vocab):
    """Two system prompts the timed run does not use: the first request
    on each misses (a fresh prefill of the 2048 bucket: its eager run,
    then its capture), and two hits at each suffix bucket 16-256 follow,
    so the timed run replays every program it runs."""
    rng = np.random.default_rng(seed)
    heads = [rng.integers(0, vocab, SYSTEM) for _ in range(2)]
    out = [(f"miss{j}", np.concatenate([heads[j], rng.integers(0, vocab, 16)])
            .astype(np.int32), 8) for j in range(2)]
    n = TAIL_LO
    while n <= TAIL_HI:
        for j in range(2):
            out.append((f"hit{n}-{j}", np.concatenate(
                [heads[0], rng.integers(0, vocab, n)]).astype(np.int32), 8))
        n *= 2
    return out


def prefix_run(engine, table, reqs, n_layers, decode_kernel, norms=2):
    """One timed run of `reqs` on a warm engine (each hit's shared prefix
    SYSTEM tokens; `norms` RMSNorms a layer, as `expected_launches`):
    its results, metrics and launch counts, with the counts its programs
    must make."""
    from shellac_tpu_torch.inference.graphs import StepGraph

    torch.cuda.synchronize()
    reset_peak()
    before = dict(engine.stats)
    reset_counts(table)
    captured = StepGraph.captures
    t0 = time.perf_counter()
    results = engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(table)
    delta = {k: engine.stats[k] - before[k] for k in engine.stats
             if isinstance(engine.stats[k], int)}
    hits = delta.get("prefix_hit_tokens", 0) // SYSTEM
    windows = delta["decode_windows"]
    L = n_layers
    expect = only(table,
                  rms_norm=(norms * L + 1) * (delta["prefills"] + windows),
                  flash_attention_fwd=L * (delta["prefills"] - hits),
                  **{decode_kernel: L * windows})
    ttft, tpot = [], []
    for rid, _, m in reqs:
        _, admitted, first, done = engine.finished_timings[rid]
        ttft.append(first - admitted)
        tpot.append((done - first) / max(m - 1, 1))
    generated = sum(len(v) for v in results.values())
    query = delta.get("prefix_query_tokens", 0)
    return results, counts, expect, dict(
        requests=len(reqs), generated_tokens=generated, wall_s=wall,
        tokens_per_s=generated / wall,
        ttft_ms_p50=pct(ttft, 50) * 1e3, ttft_ms_p99=pct(ttft, 99) * 1e3,
        tpot_ms_p50=pct(tpot, 50) * 1e3,
        hit_share=(delta.get("prefix_hit_tokens", 0) / query) if query
        else 0.0, hit_requests=hits,
        prefix_evictions=delta.get("prefix_evictions", 0),
        prefills=delta["prefills"], decode_windows=windows,
        graphs_captured=StepGraph.captures - captured,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        launches=counts, expected=expect)


def suffix_device_ms(engine, params, cfg, vocab, seed, dev, system):
    """Device ms of one prefix hit's suffix prefill (a tail of 128 past
    the cached `system` prompt; its program replayed alone on an idle
    engine, profiled), split into its plain attention (the layers'
    paged_decode_attention(impl="ref") at the same shapes, in one CUDA
    graph) and the rest; beside a miss's fresh prefill of the same
    prompt length."""
    from shellac_tpu_torch.ops.decode_attention import paged_decode_attention

    rng = np.random.default_rng(seed)
    tail = rng.integers(0, vocab, 128)
    hit = np.concatenate([system, tail]).astype(np.int32)
    miss = rng.integers(0, vocab, hit.size).astype(np.int32)
    out = {}
    for name, prompt in (("miss", miss), ("hit", hit)):
        engine.submit(f"probe-{name}", prompt, 2)
        prof = profile_call(engine.step)
        out[f"{name}_prefill_device_ms"] = prof["device_ms"]
        out[f"{name}_prefill_trace_lost"] = prof["trace_lost"]
        while engine.pending:
            engine.step()
    cache = engine._cache
    p, s = SYSTEM, 128
    h, hkv, d = cfg.n_heads, cfg.kv_heads, cfg.dim_per_head
    q = torch.randn((1, s, h, d), dtype=cfg.compute_dtype, device=dev)
    row = torch.zeros((1, cache.tables.shape[1]), dtype=torch.int32,
                      device=dev)
    row[0, :(p + s) // engine.block_size] = torch.arange(
        1, (p + s) // engine.block_size + 1, device=dev)
    index = torch.full((1,), p, dtype=torch.int32, device=dev)
    kw = ({"k_scale": cache.ks[0], "v_scale": cache.vs[0]}
          if engine.kv_quant == "int8" else {})
    attn = graph_ms(lambda: paged_decode_attention(
        q, cache.k[0], cache.v[0], row, index, impl="ref", **kw), [()],
        1) * cfg.n_layers
    out["hit_plain_attention_device_ms"] = attn
    out["hit_rest_device_ms"] = out["hit_prefill_device_ms"] - attn
    return out


def phase_prefix_serve(seed, dev, table, card):
    """serve's engine under the reference serve's scheduling (PIPELINED)
    on chat-shaped traffic: 48 requests on one shared 1024-token system
    prompt, tails of 16-256 tokens, 32-128 new tokens, greedy; once with
    prefix_cache=False and once with prefix_cache=True in one process,
    over the bf16 pool and then the int8 pool. Each timed run follows a
    warm-up and captures nothing; its launch counts are what its fresh
    prefills, suffix prefills and windows make. Printed: the hit share,
    TTFT, TPOT, tokens/s, the suffix prefill's device ms split into the
    plain attention and the rest, evictions, peak memory; at full width
    the share of sequences equal to the uncached run's and the largest
    first-token logprob difference (the suffix attends through the plain
    path, a fresh prefill through kernel 2: not gated). A second pass on
    four system prompts over a small pool must evict. A 2-layer fp32
    copy's cached and uncached tokens must be equal."""
    from shellac_tpu_torch import get_model_config
    from shellac_tpu_torch.inference.batching import PagedBatchingEngine
    from shellac_tpu_torch.models import transformer

    cfg = get_model_config("shellac-1b")
    params = transformer.init_params(cfg, seed=seed, device=dev)
    reqs = prefix_requests(seed + 20, cfg.vocab_size, REQUESTS)
    warm = prefix_warm_requests(seed + 21, cfg.vocab_size)
    main_counts = None
    failed = []
    for backend in ("paged", "paged-int8"):
        kernel = DECODE_KERNEL[backend]
        block = BLOCK if backend == "paged" else BLOCK_INT8
        runs = {}
        for cached in (False, True):
            engine = PagedBatchingEngine(
                cfg, params, n_slots=SLOTS, max_len=MAX_LEN,
                block_size=block, cache_backend=backend, decode_ticks=1,
                temperature=0.0, logprobs=True, prefix_cache=cached,
                device=dev, **PIPELINED)
            engine.run(warm)
            results, counts, expect, m = prefix_run(
                engine, table, reqs, cfg.n_layers, kernel)
            if cached:
                m.update(suffix_device_ms(engine, params, cfg,
                                          cfg.vocab_size, seed + 22, dev,
                                          reqs[0][1][:SYSTEM]))
            first_lp = {rid: engine.finished_logprobs[rid][0]
                        for rid in results}
            runs[cached] = (results, first_lp, m)
            ok = (counts == expect and m["graphs_captured"] == 0
                  and len(results) == len(reqs)
                  and (not cached or m["hit_requests"] == len(reqs) - 1))
            emit("prefix-serve", step="main_path", backend=backend,
                 prefix_cache=cached, model="shellac-1b", slots=SLOTS,
                 max_len=MAX_LEN, block_size=block, system_tokens=SYSTEM,
                 tails=[TAIL_LO, TAIL_HI], new=[PFX_NEW_LO, PFX_NEW_HI],
                 **PIPELINED, ok=ok, card=card, **m)
            if not ok:
                failed.append((backend, cached))
            if backend == "paged" and cached:
                main_counts = counts
            engine.close()
            del engine
            torch.cuda.empty_cache()
        (plain, lp0, _), (hit, lp1, _) = runs[False], runs[True]
        emit("prefix-serve", step="cached_vs_uncached", backend=backend,
             sequences_equal=sum(hit[r] == plain[r] for r in plain),
             requests=len(plain),
             first_token_logprob_max_abs_diff=max(
                 abs(lp0[r] - lp1[r]) for r in plain))

    # Eviction: four system prompts, a pool too small for all of them.
    engine = PagedBatchingEngine(
        cfg, params, n_slots=SLOTS, max_len=MAX_LEN, block_size=BLOCK,
        cache_backend="paged", decode_ticks=1, temperature=0.0,
        prefix_cache=True, pool_tokens=EVICT_POOL, device=dev, **PIPELINED)
    evict_reqs = prefix_requests(seed + 23, cfg.vocab_size, REQUESTS,
                                 systems=4)
    t0 = time.perf_counter()
    out = engine.run(evict_reqs)
    torch.cuda.synchronize()
    st = engine.stats
    evicted = st["prefix_evictions"]
    emit("prefix-serve", step="eviction", systems=4, pool_tokens=EVICT_POOL,
         requests=len(evict_reqs), completed=len(out),
         wall_s=time.perf_counter() - t0,
         hit_share=st["prefix_hit_tokens"] / st["prefix_query_tokens"],
         prefix_evictions=evicted, pool_exhausted=st["pool_exhausted"],
         cached_blocks=engine.cache_backend.residency()[
             "prefix_cached_blocks"], card=card)
    engine.close()
    del engine, params
    torch.cuda.empty_cache()
    if evicted < 1 or len(out) != len(evict_reqs):
        failed.append("eviction")

    # 2 layers in fp32: cached outputs token-equal to uncached ones.
    cfg32 = cfg.replace(n_layers=2, dtype="float32")
    p32 = transformer.init_params(cfg32, seed=seed, device=dev)
    small = prefix_requests(seed + 24, cfg32.vocab_size, 14, system_len=256,
                            tails=(8, 120), new=(4, 24))
    outs = {}
    for cached in (False, True):
        eng = PagedBatchingEngine(cfg32, p32, n_slots=6, max_len=512,
                                  prefix_cache=cached, device=dev,
                                  **PIPELINED)
        outs[cached] = eng.run(small)
        hits = eng.stats.get("prefix_hit_tokens", 0)
        eng.close()
    equal = outs[False] == outs[True]
    emit("prefix-serve", step="fp32_depth2_cached_vs_uncached",
         requests=len(small), equal=equal, hit_tokens=hits)
    del p32
    torch.cuda.empty_cache()
    if not equal or hits == 0:
        failed.append("fp32")
    if failed:
        raise SystemExit(f"prefix-serve: failed {failed}")
    return main_counts


def phase_sampling_controls(seed, dev, table, card):
    """serve's engine (shellac-1b, 16 slots, max_len 2048, 16-token
    blocks) with the per-request controls. A seeded request (temperature
    0.8) must give the same tokens alone, among 15 neighbours (seeded,
    penalised, biased, scoring and plain sampled requests) in slot 15,
    at decode_ticks 1 and 8, under both pipelines and strict; a bias of
    +100 must force its token and -100 ban it; prompt logprobs must
    match a plain forward's log-softmax within 5e-2 of its largest
    magnitude; and runs of one control each must capture exactly the
    window graphs their keys name. The neighbours' run is the phase's
    main path (its launch counts)."""
    from shellac_tpu_torch import get_model_config
    from shellac_tpu_torch.inference.batching import PagedBatchingEngine
    from shellac_tpu_torch.models import transformer

    cfg = get_model_config("shellac-1b")
    params = transformer.init_params(cfg, seed=seed, device=dev)
    vocab = cfg.vocab_size
    rng = np.random.default_rng(seed + 30)

    def prompt(n):
        return rng.integers(0, vocab, n).astype(np.int32)

    def engine(ticks=1, pipe=PIPELINED):
        return PagedBatchingEngine(
            cfg, params, n_slots=SLOTS, max_len=MAX_LEN, block_size=BLOCK,
            decode_ticks=ticks, temperature=0.0, logprobs=True, device=dev,
            **pipe)

    seeded = ("seeded", prompt(200), 64, {"temperature": 0.8, "seed": 1234})
    kinds = ([{"temperature": 0.9, "seed": i} for i in range(4)]
             + [{"presence_penalty": 0.5}, {"frequency_penalty": 0.7},
                {"presence_penalty": 0.3, "frequency_penalty": 0.3}]
             + [{"logit_bias": {int(t): 2.0 for t in prompt(3)}}
                for _ in range(3)]
             + [{"prompt_logprobs": True}] * 2
             + [{"temperature": 1.0}] * 3)
    neighbours = [(f"n{i}", prompt(int(rng.integers(64, 513))), 48, k)
                  for i, k in enumerate(kinds)]

    def run(eng, reqs):
        for rid, p, m, k in reqs:
            eng.submit(rid, p, m, **k)
        out = {}
        while eng.pending:
            out.update(eng.step())
        return out

    got = {}
    eng = engine()
    got["alone"] = run(eng, [seeded])["seeded"]
    eng.close()
    eng = engine()
    run(eng, [seeded])  # warm-up: the graphs of this mix
    reset_counts(table)
    t0 = time.perf_counter()
    mixed = run(eng, neighbours + [seeded])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(table)
    got["neighbours_slot15"] = mixed["seeded"]
    scoring = [(rid, p) for rid, p, _, k in neighbours
               if k.get("prompt_logprobs")]
    plp_err, plp_scale = 0.0, 0.0
    with torch.inference_mode():
        for rid, p in scoring:
            toks = torch.from_numpy(p.astype(np.int64))[None].to(dev)
            lsm = torch.log_softmax(transformer.forward(
                cfg, params, toks, attn_impl="ref", device=dev)[0].float(),
                dim=-1)
            ref = lsm[:-1].gather(1, toks[0, 1:, None])[:, 0].cpu().numpy()
            mine = np.asarray(eng.finished_prompt_logprobs[rid][1:])
            plp_err = max(plp_err, float(np.abs(mine - ref).max()))
            plp_scale = max(plp_scale, float(np.abs(ref).max()))
    keys_mixed = sorted(eng._window_graphs)
    eng.close()
    for name, kw in (("decode_ticks_8", {"ticks": 8}),
                     ("strict", {"pipe": {}})):
        e = engine(**kw)
        got[name] = run(e, neighbours + [seeded])["seeded"]
        e.close()
    seeded_ok = all(v == got["alone"] for v in got.values())

    # Bias +100 forces its token; -100 bans the plain greedy token.
    eng = engine()
    base = prompt(100)
    plain = run(eng, [("plain", base, 16, {})])["plain"]
    forced_tok, banned_tok = int(rng.integers(0, vocab)), plain[0]
    out = run(eng, [
        ("forced", base, 16, {"logit_bias": {forced_tok: 100.0}}),
        ("banned", base, 16, {"logit_bias": {banned_tok: -100.0}})])
    bias_ok = (all(t == forced_tok for t in out["forced"])
               and banned_tok not in out["banned"])
    eng.close()

    # A +100 bias toward tokens the grammar never allows loses to the
    # mask; without the grammar the same bias forces its token.
    from shellac_tpu_torch.inference.constraints import compile_token_dfa
    from shellac_tpu_torch.training.tokenizer import ByteTokenizer

    dfa = compile_token_dfa(r"[a-z]{3,8}", ByteTokenizer(), vocab, EOS_BYTE)
    lost = {ord("Z"): 100.0, 300: 100.0}
    eng = PagedBatchingEngine(
        cfg, params, n_slots=SLOTS, max_len=MAX_LEN, block_size=BLOCK,
        decode_ticks=1, temperature=0.0, eos_id=EOS_BYTE, device=dev,
        **PIPELINED)
    eng.submit("grammar", base, 12, constraint=dfa, logit_bias=lost)
    eng.submit("no_grammar", base, 12, logit_bias=lost)
    out = eng.run()
    eng.close()
    grammar_ok = (dfa_walk(dfa, out["grammar"])[0]
                  and not set(out["grammar"]) & set(lost)
                  and set(out["no_grammar"]) <= set(lost))

    # One control per run: the window graphs its keys name.
    eng = engine(pipe={})
    plan = [({}, (1, True, False, False, False, False)),
            ({"logit_bias": {5: 1.0}}, (1, True, True, False, False, False)),
            ({"presence_penalty": 0.5}, (1, True, False, True, False, False)),
            ({"temperature": 0.8, "seed": 7},
             (1, False, False, False, True, False))]
    for k, _ in plan:
        run(eng, [(f"k{i}", prompt(32), 12, k) for i in range(SLOTS)])
    keys = {key: r.graph is not None for key, r in eng._window_graphs.items()}
    keys_ok = keys == {key: True for _, key in plan}
    eng.close()
    del params
    torch.cuda.empty_cache()
    plp_ok = plp_err <= 5e-2 * plp_scale
    emit("sampling-controls", step="main_path", model="shellac-1b",
         slots=SLOTS, requests=len(neighbours) + 1, wall_s=wall,
         tokens_per_s=sum(len(v) for v in mixed.values()) / wall,
         launches=counts, window_graph_keys_mixed=keys_mixed,
         seeded_tokens_equal={k: v == got["alone"] for k, v in got.items()},
         seeded_distinct_tokens=len(set(got["alone"])),
         bias_forces_and_bans=bias_ok,
         grammar_beats_bias=grammar_ok,
         grammar_with_bias_tokens=out["grammar"],
         prompt_logprobs_max_abs_err=plp_err,
         prompt_logprobs_ref_max_abs=plp_scale,
         tol="max_abs_err <= 5e-2 * max|ref|",
         window_graph_keys=[list(k) for k in keys],
         window_graph_keys_as_predicted=keys_ok, card=card)
    if not (seeded_ok and bias_ok and plp_ok and keys_ok and grammar_ok):
        raise SystemExit("sampling-controls: a seeded stream moved, a bias "
                         "missed or beat a grammar, prompt logprobs "
                         "disagree or the window graphs differ from their "
                         "keys")
    return counts


# --------------------------------------------------------------------------
# constrained-serve: the DFA mask and state advance in the window and
# prefill graphs; tools and response_format over HTTP
# --------------------------------------------------------------------------

def dfa_walk(dfa, tokens):
    """(legal, last state) of `tokens` through a TokenDFA: legal when no
    token meets -1 (EOS reads the last column)."""
    st = 0
    for t in tokens:
        nxt = int(dfa.trans[st, -1 if t == dfa.eos_id else t])
        if nxt < 0:
            return False, st
        st = nxt
    return True, st


def schema_ok(v):
    """Whether a parsed value obeys CON_SCHEMA."""
    props = CON_SCHEMA["properties"]
    return (isinstance(v, dict) and set(v) == set(CON_SCHEMA["required"])
            and v["city"] in props["city"]["enum"]
            and v["days"] in props["days"]["enum"]
            and isinstance(v["ok"], bool) and v["unit"] == "celsius")


def obeys(out, dfa, kind):
    """(obeys, ended) of one constrained output: it walks its DFA without
    meeting -1, and if it ended with EOS its text matches the pattern in
    full (the schema's parses as JSON and obeys the schema)."""
    import re

    legal, _ = dfa_walk(dfa, out)
    ended = bool(out) and out[-1] == EOS_BYTE
    if not legal or not ended:
        return legal, ended
    try:
        text = bytes(out[:-1]).decode("utf-8")
    except (ValueError, UnicodeDecodeError):
        return False, ended
    if kind == "schema":
        try:
            return schema_ok(json.loads(text)), ended
        except ValueError:
            return False, ended
    return re.fullmatch(CON_REGEX, text) is not None, ended


def class_latency(engine, results, rids, wall):
    """TTFT p50/p99 (admission to first token) and TPOT p50 of `rids`,
    and their tokens a second over the run's wall."""
    ttft, tpot, n = [], [], 0
    for rid in rids:
        _, admitted, first, done = engine.finished_timings[rid]
        k = len(results[rid])
        n += k
        ttft.append(first - admitted)
        tpot.append((done - first) / max(k - 1, 1))
    return dict(requests=len(rids), tokens=n, tokens_per_s=n / wall,
                ttft_ms_p50=pct(ttft, 50) * 1e3,
                ttft_ms_p99=pct(ttft, 99) * 1e3,
                tpot_ms_p50=pct(tpot, 50) * 1e3)


def phase_constrained_serve(seed, dev, table, card):
    """serve-overlap's engine with constrained requests, over the paged
    and paged-int8 pools (see the module docstring, 11d), then the HTTP
    pass. Returns the kernel launch counts of the two timed constrained
    runs (each counted from 0 just before it)."""
    from shellac_tpu_torch import get_model_config
    from shellac_tpu_torch.inference.batching import PagedBatchingEngine
    from shellac_tpu_torch.inference.constraints import (
        compile_token_dfa,
        constraint_pattern,
    )
    from shellac_tpu_torch.inference.graphs import StepGraph
    from shellac_tpu_torch.models import transformer
    from shellac_tpu_torch.ops.dispatch import copy_from_host
    from shellac_tpu_torch.training.tokenizer import ByteTokenizer

    t_phase = time.perf_counter()
    cfg = get_model_config("shellac-1b")
    params = transformer.init_params(cfg, seed=seed, device=dev)
    tok = ByteTokenizer()
    patterns = {"schema": constraint_pattern({"json_schema": CON_SCHEMA}),
                "regex": CON_REGEX,
                # The profiled fill: a grammar no budget here ends.
                "open": r"[a-z]+( [a-z]+)*"}
    dfas, compiled = {}, {}
    for kind, pat in patterns.items():
        t0 = time.perf_counter()
        dfas[kind] = compile_token_dfa(pat, tok, cfg.vocab_size, EOS_BYTE)
        compiled[kind] = dict(
            compile_ms=(time.perf_counter() - t0) * 1e3,
            states=dfas[kind].n_states,
            table_bytes=int(dfas[kind].trans.nbytes))
    emit("constrained-serve", step="compile", vocab=cfg.vocab_size,
         tokenizer="byte", patterns=compiled, card=card)
    base = serve_requests(seed + 1, cfg.vocab_size, REQUESTS,
                          (PROMPT_LO, PROMPT_HI), (NEW_LO, NEW_HI))
    kinds = ("schema", "regex", "free")
    reqs = [(rid, toks, m, kinds[i % 3])
            for i, (rid, toks, m) in enumerate(base)]
    warm = warm_requests(seed + 2, cfg.vocab_size)
    full = serve_requests(seed + 3, cfg.vocab_size, SLOTS,
                          (PROMPT_HI // 2, PROMPT_HI // 2),
                          (NEW_HI * 2, NEW_HI * 2))
    total = {k["name"]: 0 for k in table}
    failed = []
    for backend in ("paged", "paged-int8"):
        engine = PagedBatchingEngine(
            cfg, params, n_slots=SLOTS, max_len=MAX_LEN,
            block_size=BLOCK if backend == "paged" else BLOCK_INT8,
            cache_backend=backend, decode_ticks=1, temperature=0.0,
            eos_id=EOS_BYTE, device=dev, **PIPELINED)
        # The schema's and the regex's tables placed by two requests live
        # together (the second grows the table), so the timed runs
        # upload nothing; then each table's restack, the pinned copy of
        # its rows into place, timed on its own rows.
        for i, kind in enumerate(("schema", "regex")):
            engine.submit(f"place{i}", warm[0][1], 4,
                          constraint=dfas[kind])
        engine.run()
        uploads = {}
        for kind in ("schema", "regex"):
            off = engine._cres[id(dfas[kind])][1]
            rows = engine._ctrans[off:off + dfas[kind].n_states]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            copy_from_host(rows, dfas[kind].trans)
            torch.cuda.synchronize()
            uploads[kind] = (time.perf_counter() - t0) * 1e3
        # Warm-up, not counted: every bucket's free and constrained
        # prefill graphs and both window graphs are captured.
        engine.run(warm)
        for i, (rid, toks, m) in enumerate(warm):
            engine.submit("c" + rid, toks, m,
                          constraint=dfas[kinds[i % 2]])
        engine.run()
        torch.cuda.synchronize()
        runs = {}
        for name, constrained in (("constrained", True), ("free", False)):
            before = dict(engine.stats)
            captures0 = StepGraph.captures
            reset_counts(table)
            t0 = time.perf_counter()
            for rid, toks, m, kind in reqs:
                engine.submit(rid, toks, m, **(
                    {"constraint": dfas[kind]}
                    if constrained and kind != "free" else {}))
            results = engine.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts(table)
            delta = {k: engine.stats[k] - before[k] for k in
                     ("prefills", "decode_windows", "engine_steps")}
            expect = expected_launches(table, cfg.n_layers, delta, 1,
                                       DECODE_KERNEL[backend])
            runs[name] = dict(results=results, wall=wall, counts=counts,
                              expect=expect,
                              captures=StepGraph.captures - captures0)
        con = runs["constrained"]
        checks = {}
        for kind in ("schema", "regex"):
            rids = [r for r, _, _, k in reqs if k == kind]
            res = [obeys(con["results"][r], dfas[kind], kind) for r in rids]
            checks[kind] = dict(requests=len(rids),
                                obey=sum(ok for ok, _ in res),
                                ended_with_eos=sum(e for _, e in res))
        free_rids = [r for r, _, _, k in reqs if k == "free"]
        con_rids = [r for r, _, _, k in reqs if k != "free"]
        table_bytes = int(engine._ctrans.nbytes)
        # 20 decode-only steps of 16 constrained slots, then of 16 free
        # ones (same prompts; the open grammar ends only where the model
        # picks EOS), their wall ms a step, and one more profiled.
        steps = {}
        for name, kw in (("constrained", {"constraint": dfas["open"]}),
                         ("free", {})):
            for rid, toks, m in full:
                engine.submit(name + rid, toks, m, **kw)
            while (engine._queue or engine._pflights or engine._prefilling
                   or any(r is not None and not r.out
                          for r in engine._slots)):
                engine.step()
            engine.step()
            walls = []
            for _ in range(20):
                t0 = time.perf_counter()
                engine.step()
                walls.append((time.perf_counter() - t0) * 1e3)
            decoding = sum(r is not None for r in engine._slots)
            prof = profile_call(engine.step)
            steps[name] = dict(wall_ms_per_step=walls,
                               wall_ms_per_step_p50=float(np.median(walls)),
                               slots_decoding_after=decoding,
                               device_ms=prof["device_ms"],
                               wall_ms=prof["wall_ms"],
                               device_ms_by_kind=prof["device_ms_by_kind"],
                               launches=prof["launches"],
                               trace_lost=prof["trace_lost"])
            engine.abort_all()
        clean = pristine(engine)
        ok = (all(c["obey"] == c["requests"] and c["ended_with_eos"] > 0
                  for c in checks.values())
              and all(r["captures"] == 0 and r["counts"] == r["expect"]
                      for r in runs.values())
              and set(con["results"]) == {r for r, _, _, _ in reqs}
              and clean)
        emit("constrained-serve", step="main_path", backend=backend,
             model="shellac-1b", slots=SLOTS, max_len=MAX_LEN, **PIPELINED,
             requests=len(reqs), eos_id=EOS_BYTE, checks=checks,
             table_bytes=table_bytes,
             table_rows=int(engine._ctrans.shape[0]),
             resident_tables=len(engine._cres), upload_ms=uploads,
             constrained_run=dict(
                 wall_s=con["wall"],
                 tokens_per_s=sum(len(v) for v in con["results"].values())
                 / con["wall"],
                 constrained=class_latency(engine, con["results"],
                                           con_rids, con["wall"]),
                 free=class_latency(engine, con["results"], free_rids,
                                    con["wall"]),
                 graphs_captured=con["captures"], launches=con["counts"],
                 launches_as_expected=con["counts"] == con["expect"]),
             free_run=dict(
                 wall_s=runs["free"]["wall"],
                 tokens_per_s=sum(len(v) for v in
                                  runs["free"]["results"].values())
                 / runs["free"]["wall"],
                 all=class_latency(engine, runs["free"]["results"],
                                   [r for r, _, _, _ in reqs],
                                   runs["free"]["wall"]),
                 graphs_captured=runs["free"]["captures"],
                 launches_as_expected=(runs["free"]["counts"]
                                       == runs["free"]["expect"])),
             decode_step_16_slots=steps,
             mask_device_ms=(steps["constrained"]["device_ms"]
                             - steps["free"]["device_ms"]),
             allocator_pristine=clean, ok=ok, card=card)
        if not ok:
            failed.append(backend)
        for n, c in con["counts"].items():
            total[n] += c
        engine.close()
        del engine
        reset_peak()
    failed += constrained_http(cfg, params, dev, card)
    del params
    reset_peak()
    emit("constrained-serve", step="done",
         seconds=time.perf_counter() - t_phase)
    if failed:
        raise SystemExit(f"constrained-serve: {failed}: an output left its "
                         "grammar, no output ended, a timed run captured a "
                         "graph, the launches are off or a block leaked")
    return total


def reassemble_tools(chunks):
    """An OpenAI client's reassembly of streamed tool calls: (calls by
    index, content, finish reason)."""
    calls, content, finish = {}, "", None
    for c in chunks:
        choice = c["choices"][0]
        finish = choice["finish_reason"] or finish
        d = choice["delta"]
        content += d.get("content") or ""
        for item in d.get("tool_calls", []):
            slot = calls.setdefault(item["index"],
                                    {"name": None, "args": ""})
            if "id" in item:
                slot["name"] = item["function"]["name"]
            slot["args"] += item["function"].get("arguments", "")
    return calls, content, finish


def tool_args_ok(name, args):
    fn = {t["function"]["name"]: t["function"]["parameters"]
          for t in TOOLS}[name]
    props = fn["properties"]
    return (set(args) == set(fn["required"])
            and all(args[k] in props[k]["enum"] for k in args))


def constrained_http(cfg, params, dev, card):
    """The HTTP pass of constrained-serve: chat completions with tools
    required, a named tool and response_format json_schema, streamed and
    not, through InferenceServer over the paged engine with the byte
    tokenizer. Returns the names of the checks that failed."""
    import threading

    from shellac_tpu_torch.inference.batching import PagedBatchingEngine
    from shellac_tpu_torch.inference.server import (
        InferenceServer,
        make_http_server,
    )
    from shellac_tpu_torch.obs import Registry
    from shellac_tpu_torch.training.tokenizer import ByteTokenizer

    engine = PagedBatchingEngine(
        cfg, params, n_slots=SLOTS, max_len=MAX_LEN, block_size=BLOCK,
        decode_ticks=1, temperature=0.0, eos_id=EOS_BYTE, device=dev,
        **PIPELINED)
    srv = InferenceServer(cfg, params, tokenizer=ByteTokenizer(),
                          engine=engine, model_name="shellac-1b",
                          registry=Registry())
    httpd = make_http_server(srv)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    user = [{"role": "user", "content": "weather in oslo for two days?"}]
    bodies = {
        "required": {"messages": user, "max_tokens": 200, "tools": TOOLS,
                     "tool_choice": "required",
                     "parallel_tool_calls": False},
        "named": {"messages": user, "max_tokens": 200, "tools": TOOLS,
                  "tool_choice": {"type": "function",
                                  "function": {"name": "calc"}},
                  "parallel_tool_calls": False},
        "json_schema": {"messages": user, "max_tokens": 200,
                        "response_format": {"type": "json_schema",
                                            "json_schema": {
                                                "name": "w",
                                                "schema": CON_SCHEMA}}},
    }
    checks, failed = {}, []
    try:
        for name, body in bodies.items():
            t0 = time.perf_counter()
            status, _, raw, _ = http_call(url, "/v1/chat/completions", body)
            wall = time.perf_counter() - t0
            sstatus, _, sraw, _ = http_call(
                url, "/v1/chat/completions", dict(body, stream=True),
                stream=True)
            rec = dict(status=status, stream_status=sstatus, wall_s=wall)
            ok = status == 200 and sstatus == 200
            if not ok:
                rec["error"] = (raw if status != 200 else sraw)[:400].decode(
                    errors="replace")
            if ok:
                ch = json.loads(raw)["choices"][0]
                data = [ln[6:] for ln in sraw.decode().splitlines()
                        if ln.startswith("data: ")]
                calls, content, finish = reassemble_tools(
                    [json.loads(d) for d in data[:-1]])
                rec["finish_reason"] = ch["finish_reason"]
                if name == "json_schema":
                    text = ch["message"]["content"]
                    try:
                        ok = schema_ok(json.loads(text))
                    except ValueError:
                        ok = False
                    ok = ok and content == text and finish == "stop"
                    rec["content"] = text
                else:
                    tc = (ch["message"].get("tool_calls") or [None])[0]
                    ok = (ch["finish_reason"] == "tool_calls"
                          and tc is not None
                          and finish == "tool_calls" and content == ""
                          and calls.get(0, {}).get("name")
                          == tc["function"]["name"]
                          and calls[0]["args"]
                          == tc["function"]["arguments"])
                    if ok:
                        args = json.loads(tc["function"]["arguments"])
                        ok = tool_args_ok(tc["function"]["name"], args)
                        ok = ok and (name != "named"
                                     or tc["function"]["name"] == "calc")
                        rec["call"] = tc["function"]
            rec["ok"] = ok
            checks[name] = rec
            if not ok:
                failed.append(f"http:{name}")
        _, _, metrics, _ = http_call(url, "/metrics")
        text = metrics.decode()
        cache = {r: metric_value(
            text, f'shellac_constraint_cache_total{{result="{r}"}}')
            for r in ("hit", "miss")}
        tools_ok = metric_value(
            text, 'shellac_tool_requests_total{outcome="call"}')
        compile_n = metric_value(text,
                                 "shellac_constraint_compile_seconds_count")
        metrics_ok = (cache["miss"] == 3 and (cache["hit"] or 0) >= 2
                      and compile_n == 3 and tools_ok == 4)
        if not metrics_ok:
            failed.append("http:metrics")
    finally:
        httpd.shutdown()
        srv.close()
    emit("constrained-serve", step="http", requests=checks,
         constraint_cache=cache, constraint_compiles=compile_n,
         tool_calls_counted=tools_ok, metrics_ok=metrics_ok, card=card)
    return failed


# The decode kernel each batching backend's windows launch.
DECODE_KERNEL = {"paged": "paged_decode_attention",
                 "dense": "decode_attention_dense",
                 "paged-int8": "paged_decode_attention_int8",
                 "dense-int8": "decode_attention_dense_int8"}
# The reference `serve`'s scheduling (its CLI defaults): both pipelines,
# one prefill an engine step.
PIPELINED = dict(overlap_decode=True, overlap_prefill=True,
                 max_prefills_per_step=1)


def expected_launches(table, L, stats, ticks, decode_kernel, norms=2):
    """Launch counts a batching run makes from its own counters: per
    prefill and per decode tick `norms` L + 1 RMSNorms (2 a layer, 3 or 4
    in an MLA layer: `mla_norms`), per prefill L flash forwards, per tick
    L decode attentions."""
    windows = stats["decode_windows"]
    return only(table,
                rms_norm=(norms * L + 1) * (stats["prefills"]
                                            + windows * ticks),
                flash_attention_fwd=L * stats["prefills"],
                **{decode_kernel: L * windows * ticks})


def window_prefill_parity(cfg, params, dev, table, backend, reqs, phase):
    """graph-parity's window and prefill pass over one cache: the engine
    through its CUDA graphs and run eagerly (`eager_engine`), at 1 and 4
    ticks a window, strict and pipelined (PIPELINED); every run's greedy
    tokens and logprobs must equal the eager strict engine's bit for bit,
    and a graph run's launch counts its eager twin's and what its
    prefills and windows make. Returns the failed (backend, ticks,
    ordering)."""
    from shellac_tpu_torch.inference.batching import (
        BatchingEngine,
        PagedBatchingEngine,
    )

    cls = (PagedBatchingEngine if backend.startswith("paged")
           else BatchingEngine)
    failed = []
    for ticks in (1, 4):
        runs = {}
        for mode, pipe in (("strict", {}), ("pipelined", PIPELINED)):
            for name, c in (("graph", cls), ("eager", eager_engine(cls))):
                eng = c(cfg, params, n_slots=6, max_len=512,
                        cache_backend=backend, decode_ticks=ticks,
                        logprobs=True, device=dev, **pipe)
                reset_counts(table)
                out = eng.run(reqs)
                torch.cuda.synchronize()
                st = dict(eng.stats)
                runs[mode, name] = dict(
                    out=out, lps=dict(eng.finished_logprobs),
                    launches=read_counts(table), stats=st,
                    prefill_graphs=prefill_graphs(eng),
                    expected=expected_launches(
                        table, cfg.n_layers, st, ticks,
                        DECODE_KERNEL[backend]))
                eng.close()
                del eng
        ref = runs["strict", "eager"]
        for mode in ("strict", "pipelined"):
            g, e = runs[mode, "graph"], runs[mode, "eager"]
            ok = (g["out"] == e["out"] == ref["out"]
                  and g["lps"] == e["lps"] == ref["lps"]
                  and g["launches"] == e["launches"] == g["expected"]
                  and e["launches"] == e["expected"]
                  and g["stats"]["decode_graphs"] == 1
                  and g["prefill_graphs"] > 0
                  and e["stats"]["decode_graphs"] == 0
                  and g["stats"]["decode_windows"]
                  == e["stats"]["decode_windows"] > 1)
            emit(phase, backend=backend, decode_ticks=ticks,
                 ordering=mode, layers=cfg.n_layers, dtype=cfg.dtype,
                 slots=6, requests=len(reqs),
                 tokens=sum(len(v) for v in g["out"].values()),
                 decode_windows=g["stats"]["decode_windows"],
                 prefills=g["stats"]["prefills"],
                 decode_graphs_captured=g["stats"]["decode_graphs"],
                 prefill_graphs_captured=g["prefill_graphs"],
                 tokens_identical_to_eager_strict=g["out"] == e["out"]
                 == ref["out"],
                 logprobs_identical_to_eager_strict=g["lps"] == e["lps"]
                 == ref["lps"], launches=g["launches"],
                 launches_equal_eager_and_expected=(
                     g["launches"] == e["launches"] == g["expected"]),
                 ok=ok)
            if not ok:
                failed.append((backend, ticks, mode))
    return failed


def continuation_parity(cfg, params, dev, table, backend, seed, phase):
    """graph-parity's continuation pass over one cache: chunked prefill
    (64-token chunks) and, over the pools, the prefix cache's suffix
    prefills, as graph replays against the same programs run eagerly
    (tokens, logprobs and launches equal). Returns the failures."""
    from shellac_tpu_torch.inference.batching import (
        BatchingEngine,
        PagedBatchingEngine,
    )

    paged = backend.startswith("paged")
    cls = PagedBatchingEngine if paged else BatchingEngine
    creqs = prefix_requests(seed + 25, cfg.vocab_size, 10,
                            system_len=96, tails=(8, 200), new=(4, 16))
    kw = dict(n_slots=6, max_len=512, cache_backend=backend,
              prefill_chunk=64, logprobs=True, device=dev)
    if paged:
        kw["prefix_cache"] = True
    runs = {}
    for name, c in (("graph", cls), ("eager", eager_engine(cls))):
        eng = c(cfg, params, **kw)
        reset_counts(table)
        out = eng.run(creqs)
        torch.cuda.synchronize()
        runs[name] = dict(
            out=out, lps=dict(eng.finished_logprobs),
            launches=read_counts(table), stats=dict(eng.stats),
            chunk_graphs=sum(r.graph is not None for k, r in
                             eng._prefill_graphs.items()
                             if k.kind == "chunk"))
        eng.close()
        del eng
    g, e = runs["graph"], runs["eager"]
    ok = (g["out"] == e["out"] and g["lps"] == e["lps"]
          and g["launches"] == e["launches"] and g["chunk_graphs"] > 0
          and g["stats"]["prefill_chunks"] > 0
          and (not paged or g["stats"]["prefix_hit_tokens"] > 0))
    emit(phase, backend=backend, ordering="strict",
         pass_name="continuation", prefill_chunk=64, prefix_cache=paged,
         layers=cfg.n_layers, dtype=cfg.dtype, requests=len(creqs),
         prefill_chunks=g["stats"]["prefill_chunks"],
         prefix_hit_tokens=g["stats"].get("prefix_hit_tokens", 0),
         chunk_graphs_captured=g["chunk_graphs"],
         tokens_identical_to_eager=g["out"] == e["out"],
         logprobs_identical_to_eager=g["lps"] == e["lps"],
         launches=g["launches"],
         launches_equal_eager=g["launches"] == e["launches"], ok=ok)
    return [] if ok else [(backend, "continuation")]


def phase_graph_parity(seed, dev, table):
    """The batching engines' programs (decode windows and per-bucket
    prefills) through their CUDA graphs against the same programs run
    eagerly, at shellac-1b width cut to 2 layers in bf16, over the dense
    and paged caches in bf16 and int8, at 1 and 4 ticks a window, in
    strict ordering and with both pipelines (PIPELINED): every run's
    greedy tokens and logprobs equal the eager strict engine's, bit for
    bit; a graph run's launch counts equal its eager twin's and what its
    prefills and windows make (a pipelined run makes other windows than
    a strict one: admissions join a window later, and a finished slot
    rides one more). Per cache, a continuation pass: chunked prefill
    (64-token chunks) and, over the pools, prefix-cache hits, whose
    continuation programs' graphs give the eager programs' tokens,
    logprobs and launch counts."""
    from shellac_tpu_torch import get_model_config
    from shellac_tpu_torch.inference.batching import (
        BatchingEngine,
        PagedBatchingEngine,
    )
    from shellac_tpu_torch.models import transformer

    cfg = get_model_config("shellac-1b").replace(n_layers=2)
    params = transformer.init_params(cfg, seed=seed, device=dev)
    reqs = serve_requests(seed + 4, cfg.vocab_size, 14, (16, 300), (4, 24))
    failed = []
    for backend in ("paged", "dense", "paged-int8", "dense-int8"):
        cls = (PagedBatchingEngine if backend.startswith("paged")
               else BatchingEngine)
        failed += window_prefill_parity(cfg, params, dev, table, backend,
                                        reqs, "graph-parity")
        failed += continuation_parity(cfg, params, dev, table, backend,
                                      seed, "graph-parity")
        failed += constrained_parity(cfg, params, dev, table, cls, backend,
                                     seed)
        failed += beam_graph_parity(cfg, params, dev, table, cls, backend,
                                    seed)
    del params
    torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"graph-parity: the CUDA graphs or the pipelines "
                         f"differ from the eager strict engine: {failed}")


def constrained_parity(cfg, params, dev, table, cls, backend, seed):
    """graph-parity's constrained pass over one cache: a 60-letter
    grammar (61 rows, live for 61 tokens), the schema (62 rows) twice
    and a date-time/uuid schema (84 rows) admitted last, beside free
    requests, at 1 and 4 ticks, strict and pipelined. Its first
    admissions grow the resident table to 128 rows; the last grows it
    to 256 while the 60-letter request decodes (under the pipelines,
    with a window in flight), dropping the graphs of the old table. The
    graph run's tokens, logprobs and launches equal its eager twin's,
    and both equal the eager strict run's. Returns the failed runs."""
    from shellac_tpu_torch.inference.constraints import (
        compile_token_dfa,
        constraint_pattern,
    )
    from shellac_tpu_torch.training.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    big = {"type": "object", "properties": {
        "a": {"type": "string", "format": "date-time"},
        "b": {"type": "string", "format": "uuid"}}, "required": ["a", "b"]}
    dfas = {k: compile_token_dfa(p, tok, cfg.vocab_size, EOS_BYTE)
            for k, p in (("letters", "[a-z]{60}"),
                         ("schema", constraint_pattern(
                             {"json_schema": CON_SCHEMA})),
                         ("big", constraint_pattern({"json_schema": big})))}
    t_pass = time.perf_counter()
    rng = np.random.default_rng(seed + 41)
    plan = [("letters", 64), ("schema", 56), (None, 4), (None, 6),
            (None, 5), (None, 8), ("big", 40), ("schema", 30), (None, 8)]
    reqs = [(f"c{i}", rng.integers(0, cfg.vocab_size,
                                   int(rng.integers(16, 200)))
             .astype(np.int32), m, kind)
            for i, (kind, m) in enumerate(plan)]
    failed = []
    for ticks in (1, 4):
        runs = {}
        for mode, pipe in (("strict", {}), ("pipelined", PIPELINED)):
            for name, c in (("graph", cls), ("eager", eager_engine(cls))):
                eng = c(cfg, params, n_slots=6, max_len=512,
                        cache_backend=backend, decode_ticks=ticks,
                        logprobs=True, eos_id=EOS_BYTE, device=dev, **pipe)
                grown = []
                grow = eng._grow_table

                def counting(rows, grow=grow, grown=grown, eng=eng):
                    grown.append(bool(eng._windows))
                    grow(rows)

                eng._grow_table = counting
                reset_counts(table)
                for rid, toks, m, kind in reqs:
                    eng.submit(rid, toks, m, **(
                        {"constraint": dfas[kind]} if kind else {}))
                out = eng.run()
                torch.cuda.synchronize()
                st = dict(eng.stats)
                runs[mode, name] = dict(
                    out=out, lps=dict(eng.finished_logprobs),
                    launches=read_counts(table), stats=st, grown=grown,
                    rows=int(eng._ctrans.shape[0]),
                    expected=expected_launches(table, cfg.n_layers, st,
                                               ticks, DECODE_KERNEL[backend]))
                eng.close()
                del eng
        ref = runs["strict", "eager"]
        for mode in ("strict", "pipelined"):
            g, e = runs[mode, "graph"], runs[mode, "eager"]
            walks = all(dfa_walk(dfas[kind], g["out"][rid])[0]
                        for rid, _, _, kind in reqs if kind)
            ok = (g["out"] == e["out"] == ref["out"]
                  and g["lps"] == e["lps"] == ref["lps"]
                  and g["launches"] == e["launches"] == g["expected"]
                  and g["grown"] == e["grown"] and len(g["grown"]) == 3
                  and g["rows"] == 256 and walks
                  and (mode == "strict" or g["grown"][-1]))
            emit("graph-parity", backend=backend, decode_ticks=ticks,
                 ordering=mode, pass_name="constrained", layers=2,
                 dtype="bfloat16", requests=len(reqs),
                 tokens=sum(len(v) for v in g["out"].values()),
                 table_growths_window_in_flight=g["grown"],
                 table_rows=g["rows"], outputs_walk_their_dfas=walks,
                 tokens_identical_to_eager_strict=g["out"] == e["out"]
                 == ref["out"],
                 logprobs_identical_to_eager_strict=g["lps"] == e["lps"]
                 == ref["lps"], launches=g["launches"],
                 launches_equal_eager_and_expected=(
                     g["launches"] == e["launches"] == g["expected"]),
                 ok=ok)
            if not ok:
                failed.append((backend, ticks, mode, "constrained"))
    emit("graph-parity", backend=backend, pass_name="constrained",
         seconds=time.perf_counter() - t_pass)
    return failed


# --------------------------------------------------------------------------
# train: make_train_step at bench.py's recipe
# --------------------------------------------------------------------------

def train_batch(seed, vocab, b, s, dev):
    """bench.py's batch: random tokens from the seed, inputs = targets."""
    toks = np.random.default_rng(seed).integers(0, vocab, size=(b, s))
    t = torch.from_numpy(toks.astype(np.int64)).to(dev)
    return {"inputs": t, "targets": t}


def step_counts(table, L):
    """Launches of one remat train step: every block's forward runs twice
    (the forward and its recompute), its backward once; the final norm
    once."""
    return only(table, rms_norm=4 * L + 1, flash_attention_fwd=2 * L,
                flash_attention_bwd_dkdv=L, flash_attention_bwd_dq=L)


def phase_train(seed, dev, table, card):
    from shellac_tpu_torch import get_model_config
    from shellac_tpu_torch.models import transformer
    from shellac_tpu_torch.training import (
        TrainConfig,
        init_train_state,
        make_train_step,
    )

    cfg = get_model_config("shellac-1b")
    tcfg = TrainConfig(warmup_steps=10, total_steps=1000)
    t0 = time.perf_counter()
    state = init_train_state(cfg, tcfg, seed=seed, device=dev)
    step = make_train_step(cfg, tcfg, device=dev)
    torch.cuda.synchronize()
    n_params = transformer.num_params(state.params)
    emit("train", step="init", model="shellac-1b", params=n_params,
         remat=cfg.remat, remat_policy=cfg.remat_policy,
         seconds=time.perf_counter() - t0)
    batch = train_batch(seed, cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, dev)

    state, m = step(state, batch)  # warm-up (cuBLAS, allocator)
    warm_loss = m["loss"].item()
    torch.cuda.synchronize()
    reset_peak()

    reset_counts(table)
    losses, skipped, step_s = [], [], []
    t_all = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(m["loss"].item())
        step_s.append(time.perf_counter() - t0)
        skipped.append(m["update_skipped"].item())
    total_s = time.perf_counter() - t_all
    counts = read_counts(table)
    peak = torch.cuda.max_memory_allocated()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    # bench.py's model FLOPs per token: 6 N + 12 L D S (utils/metrics.py).
    flops_tok = 6 * n_params + 12 * cfg.n_layers * cfg.d_model * TRAIN_SEQ
    step_mean = total_s / TRAIN_STEPS
    tflops = flops_tok * tokens / step_mean / 1e12
    expect = {k: TRAIN_STEPS * n
              for k, n in step_counts(table, cfg.n_layers).items()}
    ok = (all(np.isfinite(losses)) and not any(skipped)
          and losses[-1] < losses[0] and counts == expect)
    emit("train", step="main_path", model="shellac-1b", batch=TRAIN_BATCH,
         seq=TRAIN_SEQ, steps=TRAIN_STEPS, warmup_step_loss=warm_loss,
         losses=losses, update_skipped=skipped, step_ms=step_mean * 1e3,
         step_ms_min=min(step_s) * 1e3, step_ms_max=max(step_s) * 1e3,
         tokens_per_s=tokens / step_mean,
         model_flops_per_token=flops_tok, model_tflops_per_s=tflops,
         peak_share=tflops * 1e12 / PEAK_FLOPS_S[torch.bfloat16],
         peak=BF16_PEAK_NAME, max_memory_allocated=peak, launches=counts,
         expected=expect, ok=ok, card=card)
    if not ok:
        raise SystemExit("train: non-finite or rising loss, a skipped "
                         "update, or wrong launch counts")

    # Packed documents through all three attention kernels at full width.
    packed = dict(batch, segment_ids=packed_segments(
        TRAIN_BATCH, TRAIN_SEQ, dev))
    before = read_counts(table)
    state, m = step(state, packed)
    loss = m["loss"].item()
    got = {k: v - before[k] for k, v in read_counts(table).items()}
    ok = (np.isfinite(loss) and m["update_skipped"].item() == 0
          and got == step_counts(table, cfg.n_layers))
    emit("train", step="packed_segments", loss=loss, launches=got, ok=ok)
    if not ok:
        raise SystemExit("train: the packed step failed")
    for name in got:
        counts[name] += got[name]

    prof = profile_call(lambda: step(state, batch), top=30)
    head = profile_lm_head(cfg, state.params, dev)
    gemm = prof["device_ms_by_kind"].get("gemm", 0.0)
    head_gemm = head["device_ms_by_kind"].get("gemm", 0.0)
    emit("train", step="profile_step", card=card,
         gemm_lm_head_ms=head_gemm, gemm_other_ms=gemm - head_gemm, **prof)
    emit("train", step="profile_lm_head", card=card, **head)
    del state, step, batch, packed
    torch.cuda.empty_cache()
    return counts


def profile_lm_head(cfg, params, dev):
    """Device time by kernel of the LM head alone at the train step's
    shapes: its forward product from the (B S, D) bf16 hidden and its two
    backward products, as each train step runs them once (the head sits
    outside the remat blocks). Its GEMMs are the LM head's share of the
    step profile's `gemm` kind."""
    from shellac_tpu_torch.models.transformer import (
        LMHeadFunction,
        output_weights,
    )

    n = TRAIN_BATCH * TRAIN_SEQ
    x = torch.randn((n, cfg.d_model), device=dev).to(
        cfg.compute_dtype).requires_grad_()
    w = output_weights(cfg, params).detach().requires_grad_()
    g = torch.randn((n, cfg.vocab_size), device=dev) * 1e-4

    def fwd():
        return LMHeadFunction.apply(x, w)

    def fn():
        torch.autograd.grad(fwd(), (x, w), g)

    fn()
    torch.cuda.synchronize()
    prof = profile_call(fn)
    with torch.no_grad():
        fwd_ms = eager_ms(fwd, [()], 3)
    return dict(prof, event_ms_forward=fwd_ms,
                event_ms_forward_backward=eager_ms(fn, [()], 3))


def phase_train_parity(seed, dev):
    """Three fp32 steps through the kernels against the same steps with
    attn_impl="ref" (RMSNorm is the kernel in both), at shellac-1b width
    cut to 2 layers, batch 2 x seq 512, unpacked and packed. Tolerances:
    loss within 1e-4 of its value, grad_norm within 1e-3; every gradient
    leaf of the first step within 1e-4 of that leaf's max-abs (fp32
    through the kernels differs from the plain path by summation order;
    later steps add adam's normalisation of near-zero gradients)."""
    from shellac_tpu_torch import get_model_config
    from shellac_tpu_torch.models import transformer
    from shellac_tpu_torch.training import (
        TrainConfig,
        cross_entropy,
        init_train_state,
        make_train_step,
        named_leaves,
    )

    cfg = get_model_config("shellac-1b").replace(n_layers=2,
                                                 dtype="float32")
    tcfg = TrainConfig(warmup_steps=1, total_steps=1000)
    b, s = 2, 512
    failed = []
    for packed in (False, True):
        batches = [train_batch(seed + 10 + i, cfg.vocab_size, b, s, dev)
                   for i in range(3)]
        if packed:
            for bt in batches:
                bt["segment_ids"] = packed_segments(b, s, dev)
        runs, first = {}, {}
        for impl in ("auto", "ref"):
            state = init_train_state(cfg, tcfg, seed=seed, device=dev)
            bt = batches[0]
            loss, _ = cross_entropy(transformer.forward(
                cfg, state.params, bt["inputs"],
                segment_ids=bt.get("segment_ids"), attn_impl=impl,
                device=dev), bt["targets"])
            paths = [str(p) for p, _ in named_leaves(state.params)]
            leaves = [p for _, p in named_leaves(state.params)]
            first[impl] = torch.autograd.grad(loss, leaves)
            step = make_train_step(cfg, tcfg, attn_impl=impl, device=dev)
            out = []
            for bt in batches:
                state, m = step(state, bt)
                out.append((m["loss"].item(), m["grad_norm"].item()))
            runs[impl] = out
            del state, step
        worst, worst_leaf = 0.0, None
        for path, g, w in zip(paths, first["auto"], first["ref"]):
            scale = w.abs().max().clamp_min(1e-30)
            err = ((g - w).abs().max() / scale).item()
            if err >= worst:
                worst, worst_leaf = err, path
        steps_ok = all(
            abs(a[0] - r[0]) <= 1e-4 * abs(r[0])
            and abs(a[1] - r[1]) <= 1e-3 * abs(r[1])
            for a, r in zip(runs["auto"], runs["ref"]))
        ok = steps_ok and worst <= 1e-4 and all(
            np.isfinite(x) for run in runs.values() for st in run
            for x in st)
        emit("train-parity", packed=packed, layers=2, dtype="float32",
             batch=b, seq=s, kernels=runs["auto"], ref=runs["ref"],
             first_step_grad_max_err_over_scale=worst,
             worst_leaf=worst_leaf, grad_leaves=len(paths),
             tol="loss 1e-4 rel, grad_norm 1e-3 rel, grads 1e-4 of "
                 "each leaf's max-abs", ok=ok)
        if not ok:
            failed.append(packed)
        del first, runs
        torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"train-parity failed (packed={failed})")


# --------------------------------------------------------------------------
# training, whole: kernels 3 and 4 at MLA's 192, the families, the options
# --------------------------------------------------------------------------

# MLA's training shape (shellac-mla-2b, bench.py's 6 x 2048): 16 heads of
# q, k and v, 192 wide, v padded from 128 (its dO's pad lanes are zero).
MLA_TRAIN_CASES = {
    "mla_train": (TRAIN_BATCH, TRAIN_SEQ, False),
    "mla_packed": (TRAIN_BATCH, TRAIN_SEQ, True),
    "mla_odd_s1999": (2, 1999, True),
}
# The rows of the kernels' instances at 192 in the kernels line: name,
# wrapper (its launches counted on the MLA families' steps), source, the
# TPU kernel it replaces.
TRAIN_192_ROWS = (
    ("flash_attention_fwd_d192_segments", "flash_attention_fwd",
     "shellac_tpu_torch/csrc/flash_attention.cu",
     "shellac_tpu/ops/flash_attention.py:226"),
    ("flash_attention_bwd_dkdv_d192", "flash_attention_bwd_dkdv",
     "shellac_tpu_torch/csrc/flash_attention_bwd.cu",
     "shellac_tpu/ops/flash_attention.py:401"),
    ("flash_attention_bwd_dq_d192", "flash_attention_bwd_dq",
     "shellac_tpu_torch/csrc/flash_attention_bwd.cu",
     "shellac_tpu/ops/flash_attention.py:454"),
)


def mla_train_inputs(gen, dtype, dev, b, s):
    q, k, v = flash_inputs(gen, dtype, dev, b, s, MLA_HEADS, MLA_HEADS,
                           MLA_QK)
    do = randn(gen, (b, s, MLA_HEADS, MLA_QK), dtype, dev)
    pad = (0, MLA_QK - 128)
    return (q, k, F.pad(v[..., :128], pad).contiguous(),
            F.pad(do[..., :128], pad).contiguous())


def live_pairs(b, h, s, seg):
    """(q, k) pairs a causal call needs: within each row's documents."""
    if seg is None:
        return b * h * s * (s + 1) // 2
    lens = torch.unique_consecutive(seg[0], return_counts=True)[1].tolist()
    return b * h * sum(n * (n + 1) // 2 for n in lens)


def phase_kernels_train_192(gen, dev, card):
    """Kernels 2 (with packed segments), 3 and 4 at MLA's head width 192
    against their plain versions in bf16 and fp32 at MLA's training
    shape, packed, and at an odd S; the autograd Function's (dq, dk, dv)
    against autograd through the plain attention. Then their card ms (CUDA
    graph), plain ms, bound and library ms at 6 x 2048: SDPA with the
    documents' block-diagonal causal mask for the forward, SDPA's
    backward (dq, dk and dv in one call) for kernels 3 and 4. Returns
    (errs, times) of TRAIN_192_ROWS."""
    from shellac_tpu_torch.ops import flash_attention as fa

    bf, f32 = torch.bfloat16, torch.float32
    failed, errs, times = [], {}, {}

    def check(kernel, case, dtype, res, main):
        emit("kernels-train", kernel=kernel, case=case, dtype=str(dtype),
             **res)
        if main:
            errs[kernel] = max(errs.get(kernel, 0.0), res["max_abs_err"])
        if not res["ok"]:
            failed.append((kernel, case, str(dtype)))

    for dtype in (bf, f32):
        for case, (b, s, packed) in MLA_TRAIN_CASES.items():
            main = dtype == bf and case != "mla_odd_s1999"
            q, k, v, do = mla_train_inputs(gen, dtype, dev, b, s)
            seg = packed_segments(b, s, dev) if packed else None
            out, lse = fa.flash_attention_cuda(q, k, v, segments=seg,
                                               with_lse=True)
            rout, rlse = fa.flash_forward_ref(q, k, v, segments=seg)
            torch.cuda.synchronize()
            fwd = ("flash_attention_fwd_d192_segments" if packed
                   else "flash_attention_fwd_d192")
            check(fwd, f"{case}/out", dtype, compare(out, rout, dtype),
                  main and packed)
            check(fwd, f"{case}/lse", dtype, compare(lse, rlse, dtype),
                  False)
            del rout, rlse
            delta = torch.einsum("bshd,bshd->bhs", do.float(),
                                 out.float()).contiguous()
            dk, dv = fa.flash_bwd_dkdv_cuda(q, k, v, do, lse, delta,
                                            segments=seg)
            dq = fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, segments=seg)
            torch.cuda.synchronize()
            rdk, rdv = fa.flash_bwd_dkdv_ref(q, k, v, do, lse, delta,
                                             segments=seg)
            check("flash_attention_bwd_dkdv_d192", f"{case}/dk", dtype,
                  compare_scaled(dk, rdk, dtype), main)
            check("flash_attention_bwd_dkdv_d192", f"{case}/dv", dtype,
                  compare_scaled(dv, rdv, dtype), main)
            del rdk, rdv
            rdq = fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, segments=seg)
            check("flash_attention_bwd_dq_d192", f"{case}/dq", dtype,
                  compare_scaled(dq, rdq, dtype), main)
            del rdq, dk, dv, dq, out, lse, delta
            grads = {}
            for impl, fn in (("function", fa.flash_attention),
                             ("autograd_ref", fa.flash_attention_ref)):
                ins = [t.detach().clone().requires_grad_() for t in (q, k, v)]
                grads[impl] = torch.autograd.grad(fn(*ins, segments=seg),
                                                  ins, do)
                del ins
            torch.cuda.synchronize()
            for name, g, w in zip(("dq", "dk", "dv"), grads["function"],
                                  grads["autograd_ref"]):
                check("flash_attention_function_d192", f"{case}/{name}",
                      dtype, compare_scaled(g, w, dtype), False)
            del grads, q, k, v, do
            torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"kernels-train: the kernels at 192 disagree with "
                         f"their plain versions: {failed}")
    check_bodies_192(gen, dev)

    b, s, h, d = TRAIN_BATCH, TRAIN_SEQ, MLA_HEADS, MLA_QK
    shape = [b, s, h, h, d]
    qbytes, rowbytes = b * s * h * d * 2, b * h * s * 4

    def row(kernel, case, k_ms, p_ms, lib_ms, nbytes, flops, what):
        bms, by = bound(nbytes, flops, bf)
        r = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bms, "bound_by": by,
             "library_ms": lib_ms, "library_what": what, "shape": shape}
        emit("kernels-train", step="timings", kernel=kernel, case=case,
             dtype="bf16", bytes=nbytes, flops=flops,
             roofline_share=bms / k_ms,
             achieved_tflops=flops / (k_ms * 1e-3) / 1e12, card=card, **r)
        times[kernel] = r

    seg = packed_segments(b, s, dev)

    def make():
        q, k, v, do = mla_train_inputs(gen, bf, dev, b, s)
        out, lse = fa.flash_attention_cuda(q, k, v, with_lse=True)
        delta = torch.einsum("bshd,bshd->bhs", do.float(),
                             out.float()).contiguous()
        return q, k, v, do, lse, delta

    sets = copies(make)
    same = seg[:, :, None] == seg[:, None, :]
    mask = (same & torch.ones(s, s, dtype=torch.bool, device=dev).tril())[
        :, None]
    pairs = live_pairs(b, h, s, seg)
    row("flash_attention_fwd_d192_segments", "mla_packed_6x2048",
        graph_ms(lambda q, k, v, do, lse, dl: fa.flash_attention_cuda(
            q, k, v, segments=seg, with_lse=True), sets, 10),
        eager_ms(lambda q, k, v, do, lse, dl: fa.flash_forward_ref(
            q, k, v, segments=seg), sets[:1], 2),
        graph_ms(lambda q, k, v, do, lse, dl: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask), sets, 10),
        4 * qbytes + rowbytes + b * s * 4, 4 * d * pairs,
        "SDPA with the block-diagonal causal mask")
    del mask, same

    def sdpa_graph(q, k, v, do, lse, dl):
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        return qt, kt, vt, out, do.transpose(1, 2)

    lib_sets = [sdpa_graph(*a) for a in sets]
    lib = eager_ms(lambda qt, kt, vt, out, dot: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), lib_sets, 5)
    del lib_sets
    pairs = live_pairs(b, h, s, None)
    row("flash_attention_bwd_dkdv_d192", "mla_causal_6x2048",
        graph_ms(lambda q, k, v, do, lse, dl: fa.flash_bwd_dkdv_cuda(
            q, k, v, do, lse, dl), sets, 3),
        eager_ms(lambda q, k, v, do, lse, dl: fa.flash_bwd_dkdv_ref(
            q, k, v, do, lse, dl), sets[:1], 2),
        lib, 6 * qbytes + 2 * rowbytes, 8 * d * pairs,
        "SDPA backward (dq, dk and dv in one call, eager)")
    row("flash_attention_bwd_dq_d192", "mla_causal_6x2048",
        graph_ms(lambda q, k, v, do, lse, dl: fa.flash_bwd_dq_cuda(
            q, k, v, do, lse, dl), sets, 3),
        eager_ms(lambda q, k, v, do, lse, dl: fa.flash_bwd_dq_ref(
            q, k, v, do, lse, dl), sets[:1], 2),
        lib, 5 * qbytes + 2 * rowbytes, 6 * d * pairs,
        "SDPA backward (dq, dk and dv in one call, eager)")
    del sets
    torch.cuda.empty_cache()
    return errs, times


def check_bodies_192(gen, dev):
    """A bf16 call of kernel 3 or 4 at 192 launches its wgmma body and no
    CUDA-core body (by the profiler's kernel names; a trace that holds
    no kernel is taken again, twice at most)."""
    from shellac_tpu_torch.ops import flash_attention as fa

    q, k, v, do = mla_train_inputs(gen, torch.bfloat16, dev, 1, 512)
    out, lse = fa.flash_attention_cuda(q, k, v, with_lse=True)
    delta = torch.einsum("bshd,bshd->bhs", do.float(),
                         out.float()).contiguous()
    bodies = {}
    for name, fn in (
            ("flash_bwd_dkdv", lambda: fa.flash_bwd_dkdv_cuda(
                q, k, v, do, lse, delta)),
            ("flash_bwd_dq", lambda: fa.flash_bwd_dq_cuda(
                q, k, v, do, lse, delta))):
        for _ in range(3):
            top = profile_call(fn, top=4)["top"]
            if top:
                break
        bodies[name] = [(t["kernel"], t["count"]) for t in top]
    ok = all(len(v) == 1 and v[0][1] == 1 and f"{n}_wgmma" in v[0][0]
             and "_simt" not in v[0][0] for n, v in bodies.items())
    emit("kernels-train", step="bodies_bf16_d192", bodies=bodies, ok=ok)
    if not ok:
        raise SystemExit(f"kernels-train: a bf16 call at 192 did not run "
                         f"its wgmma body alone: {bodies}")


def active_params(cfg, params):
    """Parameters a token activates: every leaf but the routed experts,
    and num_experts_per_token / num_experts of theirs."""
    from shellac_tpu_torch.models import transformer

    n = transformer.num_params(params)
    if cfg.moe is None:
        return n
    routed = sum(lp[k].numel() for lp in params["layers"]
                 for k in ("w_gate", "w_up", "w_down", "b_gate", "b_up",
                           "b_down") if "w_router" in lp and k in lp)
    m = cfg.moe
    return n - routed + routed * m.num_experts_per_token // m.num_experts


def train_run(name, cfg, tcfg, b, s, seed, dev, table, card, phase,
              steps=3, profile=True, extra=None):
    """A few timed steps of make_train_step: step ms, tokens/s, model
    TFLOP/s (6 N + 12 L D S a token, N the active parameters) and its
    share of the bf16 peak, peak memory, the losses, launches; a profile
    of one step by kernel kind. Returns (state, step, batch, counts)."""
    from shellac_tpu_torch.models import transformer
    from shellac_tpu_torch.training import init_train_state, make_train_step

    reset_peak()
    t0 = time.perf_counter()
    state = init_train_state(cfg, tcfg, seed=seed, device=dev)
    step = make_train_step(cfg, tcfg, device=dev)
    batch = train_batch(seed, cfg.vocab_size, b, s, dev)
    state, m = step(state, batch)  # warm-up
    warm = m["loss"].item()
    init_s = time.perf_counter() - t0
    before = read_counts(table)
    losses, skipped = [], []
    torch.cuda.synchronize()
    t_all = time.perf_counter()
    for _ in range(steps):
        state, m = step(state, batch)
        losses.append(m["loss"].item())
        skipped.append(m["update_skipped"].item())
    step_ms = (time.perf_counter() - t_all) / steps * 1e3
    counts = {k: v - before[k] for k, v in read_counts(table).items()}
    n_all = transformer.num_params(state.params)
    n_act = active_params(cfg, state.params)
    flops_tok = 6 * n_act + 12 * cfg.n_layers * cfg.d_model * s
    tflops = flops_tok * b * s / (step_ms * 1e-3) / 1e12
    moe = {k: m[k].item() for k in m if k.startswith("moe_")}
    ok = all(np.isfinite(losses)) and not any(skipped)
    line = dict(model=name, batch=b, seq=s, steps=steps, params=n_all,
                active_params=n_act,
                flops_formula="6 N + 12 L D S, N the active parameters",
                optimizer=tcfg.optimizer, remat=cfg.remat,
                remat_policy=cfg.remat_policy, quant=tcfg.quant,
                grad_accum=tcfg.grad_accum, ema=tcfg.ema_decay,
                fused_loss_chunk=tcfg.fused_loss_chunk,
                init_and_warm_s=init_s, warm_loss=warm, losses=losses,
                update_skipped=skipped, step_ms=step_ms,
                tokens_per_s=b * s / (step_ms * 1e-3),
                model_flops_per_token=flops_tok, model_tflops_per_s=tflops,
                peak_share=tflops * 1e12 / PEAK_FLOPS_S[torch.bfloat16],
                peak=BF16_PEAK_NAME,
                max_memory_allocated=torch.cuda.max_memory_allocated(),
                launches=counts, ok=ok, card=card, **moe, **(extra or {}))
    if profile:
        prof = profile_call(lambda: step(state, batch), top=12)
        line["profile"] = prof
        # Kernels 3 and 4's share of the step's device time.
        kinds = prof["device_ms_by_kind"]
        line["flash_bwd_device_share"] = None if prof["trace_lost"] else (
            (kinds.get("flash_attention_bwd_dkdv", 0.0)
             + kinds.get("flash_attention_bwd_dq", 0.0)) / prof["device_ms"])
    emit(phase, **line)
    if not ok:
        raise SystemExit(f"{phase}: {name}: a non-finite loss or a skipped "
                         "update")
    return state, step, batch, counts


def phase_train_families(seed, dev, table, card):
    """The MLA and MoE families trained on the card with adamw and remat,
    random weights: shellac-mla-2b at full width and depth (6 x 2048, and
    one packed step through kernel 2's 192 instance with segments);
    DeepSeek-V2-Lite's width cut to 4 layers (the dense first layer and 3
    MoE layers: MLA and MoE in one step), 4 x 2048; GPT-OSS-20B's width
    cut to 2 layers (a window and a full layer), 4 x 2048, with the fused
    loss (chunk 12568 = 201088 / 16), and one step without it for the
    peak memory. Full depth needs more than one card under adamw (14
    bytes a parameter). Returns {family: launches} and the packed step's
    launches."""
    from shellac_tpu_torch import get_model_config
    from shellac_tpu_torch.models.convert import HFConfig, config_from_hf
    from shellac_tpu_torch.training import TrainConfig, make_train_step

    tcfg = TrainConfig(warmup_steps=10, total_steps=1000)
    out = {}
    reset_counts(table)
    cfg = get_model_config("shellac-mla-2b")
    state, step, batch, out["mla-2b"] = train_run(
        "shellac-mla-2b", cfg, tcfg, TRAIN_BATCH, TRAIN_SEQ, seed, dev,
        table, card, "train-families", extra={"cut": "none"})
    before = read_counts(table)
    packed = dict(batch, segment_ids=packed_segments(TRAIN_BATCH, TRAIN_SEQ,
                                                     dev))
    state, m = step(state, packed)
    seg_counts = {k: v - before[k] for k, v in read_counts(table).items()}
    ok = np.isfinite(m["loss"].item()) and all(
        seg_counts[n] > 0 for n in ("flash_attention_fwd",
                                    "flash_attention_bwd_dkdv",
                                    "flash_attention_bwd_dq"))
    emit("train-families", model="shellac-mla-2b", step="packed_segments",
         loss=m["loss"].item(), launches=seg_counts, ok=ok)
    if not ok:
        raise SystemExit("train-families: the packed MLA step failed")
    del state, step, batch, packed
    cfg = config_from_hf(HFConfig(dict(DEEPSEEK_V2_LITE_HF,
                                       num_hidden_layers=4)))
    state, step, batch, out["deepseek-v2-lite-4l"] = train_run(
        "deepseek-v2-lite (4 of 27 layers)", cfg, tcfg, 4, TRAIN_SEQ, seed,
        dev, table, card, "train-families",
        extra={"cut": "layers 27 -> 4 (1 dense, 3 MoE)"})
    del state, step, batch
    cfg = gptoss_20b().replace(n_layers=2, remat=True)
    fused = tcfg.replace(fused_loss_chunk=12568)
    state, step, batch, out["gpt-oss-20b-2l"] = train_run(
        "gpt-oss-20b (2 of 24 layers)", cfg, fused, 4, TRAIN_SEQ, seed, dev,
        table, card, "train-families",
        extra={"cut": "layers 24 -> 2 (a window and a full layer)"})
    fused_peak = torch.cuda.max_memory_allocated()
    reset_peak()
    plain = make_train_step(cfg, tcfg, device=dev)
    before = read_counts(table)
    state, m = plain(state, batch)
    loss = m["loss"].item()
    plain_peak = torch.cuda.max_memory_allocated()
    extra = {k: v - before[k] for k, v in read_counts(table).items()}
    for k in out["gpt-oss-20b-2l"]:
        out["gpt-oss-20b-2l"][k] += extra[k]
    grads_peak = loss_grads_peaks(cfg, state.params, batch, 12568)
    emit("train-families", model="gpt-oss-20b (2 of 24 layers)",
         step="unfused_loss", loss=loss,
         step_max_memory_allocated_unfused=plain_peak,
         step_max_memory_allocated_fused=fused_peak,
         **grads_peak, card=card)
    del state, step, batch, plain
    reset_peak()
    return out, seg_counts


def loss_grads_peaks(cfg, params, batch, chunk):
    """Peak memory of the loss and its gradients alone (the forward, the
    loss, the backward; no optimizer update), over a baseline of the
    model and its state, with the fused loss and with the whole logits."""
    from shellac_tpu_torch.models import transformer
    from shellac_tpu_torch.training import cross_entropy, fused_cross_entropy
    from shellac_tpu_torch.training.train_state import leaves

    out = {}
    for name in ("fused", "unfused"):
        reset_peak()
        base = torch.cuda.memory_allocated()
        if name == "fused":
            h = transformer.forward(cfg, params, batch["inputs"],
                                    return_hidden=True)
            loss, _ = fused_cross_entropy(
                h, transformer.output_weights(cfg, params),
                batch["targets"], vocab_chunk=chunk)
        else:
            loss, _ = cross_entropy(transformer.forward(
                cfg, params, batch["inputs"]), batch["targets"])
        grads = torch.autograd.grad(loss, leaves(params))
        torch.cuda.synchronize()
        out[f"loss_and_grads_peak_over_state_{name}"] = (
            torch.cuda.max_memory_allocated() - base)
        del grads, loss
    return out


def phase_train_options(seed, dev, table, card):
    """The train step's options at shellac-1b, bench.py's 6 x 2048, each
    from the same seed on the same batch against adamw with remat "none":
    lion, adafactor and muon; quant int8 and int8_bwd; remat "dots" and
    "dots_no_batch"; grad_accum 2 at 12 x 2048; the EMA. Each prints its
    step ms, peak memory and the loss after the same number of steps.
    Then transformer.forward at shellac-270m on (2, 512) tokens
    (`__graft_entry__.py` entry()'s call): logits (2, 512, 32768)."""
    from shellac_tpu_torch import get_model_config
    from shellac_tpu_torch.models import transformer
    from shellac_tpu_torch.training import TrainConfig

    base = get_model_config("shellac-1b")
    tcfg = TrainConfig(warmup_steps=1, total_steps=1000)
    runs = {
        "adamw": (base, tcfg, TRAIN_BATCH),
        "lion": (base, tcfg.replace(optimizer="lion"), TRAIN_BATCH),
        "adafactor": (base, tcfg.replace(optimizer="adafactor"),
                      TRAIN_BATCH),
        "muon": (base, tcfg.replace(optimizer="muon"), TRAIN_BATCH),
        "quant_int8": (base, tcfg.replace(quant="int8"), TRAIN_BATCH),
        "quant_int8_bwd": (base, tcfg.replace(quant="int8_bwd"),
                           TRAIN_BATCH),
        "remat_dots": (base.replace(remat_policy="dots"), tcfg, TRAIN_BATCH),
        "remat_dots_no_batch": (base.replace(remat_policy="dots_no_batch"),
                                tcfg, TRAIN_BATCH),
        "grad_accum_2": (base, tcfg.replace(grad_accum=2), 2 * TRAIN_BATCH),
        "ema": (base, tcfg.replace(ema_decay=0.999), TRAIN_BATCH),
    }
    counts = None
    reset_counts(table)
    for name, (cfg, tc, b) in runs.items():
        state, step, batch, c = train_run(
            f"shellac-1b/{name}", cfg, tc, b, TRAIN_SEQ, seed, dev, table,
            card, "train-options", steps=2, profile=False)
        counts = c if counts is None else {k: counts[k] + c[k] for k in c}
        del state, step, batch
    reset_peak()
    cfg = get_model_config("shellac-270m")
    params = transformer.init_params(cfg, seed=seed, device=dev)
    tokens = torch.zeros((2, 512), dtype=torch.int64, device=dev)
    with torch.no_grad():
        before = read_counts(table)
        logits = transformer.forward(cfg, params, tokens, device=dev)
        got = {k: v - before[k] for k, v in read_counts(table).items()}
        ms = eager_ms(lambda: transformer.forward(cfg, params, tokens,
                                                  device=dev), [()], 5)
    ok = (tuple(logits.shape) == (2, 512, 32768)
          and bool(torch.isfinite(logits).all().item()))
    emit("train-options", model="shellac-270m", step="forward",
         shape=list(logits.shape), dtype=str(logits.dtype), forward_ms=ms,
         launches=got, ok=ok, card=card)
    if not ok:
        raise SystemExit("train-options: shellac-270m's forward failed")
    for k in counts:
        counts[k] += got[k]
    del params, logits
    reset_peak()
    return counts


def phase_train_parity_families(seed, dev):
    """Three fp32 steps of the MLA and MoE families, 2 layers at full
    width (shellac-mla-2b; DeepSeek-V2-Lite's dense first layer and an
    MoE layer), batch 2 x 512, through the kernels (kernels 2-4 at 192)
    and through the plain attention (attn_impl="ref"), each held to the
    other as `phase_train_parity` holds shellac-1b."""
    from shellac_tpu_torch import get_model_config
    from shellac_tpu_torch.models.convert import HFConfig, config_from_hf
    from shellac_tpu_torch.training import TrainConfig, make_train_step
    from shellac_tpu_torch.training import init_train_state

    tcfg = TrainConfig(warmup_steps=1, total_steps=1000)
    b, s = 2, 512
    families = {
        "shellac-mla-2b": get_model_config("shellac-mla-2b"),
        "deepseek-v2-lite": config_from_hf(HFConfig(dict(
            DEEPSEEK_V2_LITE_HF, num_hidden_layers=2))),
    }
    failed = []
    for name, cfg in families.items():
        cfg = cfg.replace(n_layers=2, dtype="float32")
        batches = [train_batch(seed + 20 + i, cfg.vocab_size, b, s, dev)
                   for i in range(3)]
        batches[2]["segment_ids"] = packed_segments(b, s, dev)
        runs = {}
        for impl in ("auto", "ref"):
            state = init_train_state(cfg, tcfg, seed=seed, device=dev)
            step = make_train_step(cfg, tcfg, attn_impl=impl, device=dev)
            out = []
            for bt in batches:
                state, m = step(state, bt)
                out.append((m["loss"].item(), m["grad_norm"].item()))
            runs[impl] = out
            del state, step
            torch.cuda.empty_cache()
        ok = all(abs(a[0] - r[0]) <= 1e-4 * abs(r[0])
                 and abs(a[1] - r[1]) <= 1e-3 * abs(r[1])
                 and np.isfinite(a).all()
                 for a, r in zip(runs["auto"], runs["ref"]))
        emit("train-parity", model=name, layers=2, dtype="float32", batch=b,
             seq=s, kernels=runs["auto"], ref=runs["ref"],
             tol="loss 1e-4 rel, grad_norm 1e-3 rel", ok=ok)
        if not ok:
            failed.append(name)
    if failed:
        raise SystemExit(f"train-parity failed: {failed}")


def phase_cli_train(seed, dev, card):
    """`python -m shellac_tpu_torch train` in subprocesses on shellac-1b cut
    to 2 layers (a --config file), 2 x 512, 6 steps with --ckpt-dir
    (checkpoints at step 4 and at the end); then the run is cut back to
    its step-4 checkpoint (its step-6 directory removed, as a run that
    died after step 4 leaves it) and resumed on the same flags; then
    `eval` on the checkpoint, in process (`cli.main`). The resumed run's
    last two losses and its final weights are held to the uninterrupted
    run's."""
    import os
    import shutil
    import tempfile

    from shellac_tpu_torch.training.checkpoint import Checkpointer
    from shellac_tpu_torch.training.train_state import named_leaves

    here = os.path.dirname(os.path.abspath(__file__))

    def run(argv):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "shellac_tpu_torch", *argv],
                           cwd=here, capture_output=True, text=True,
                           timeout=600)
        if r.returncode != 0:
            raise SystemExit(f"cli-train: {argv[0]} exit {r.returncode}: "
                             f"{r.stderr[-3000:]}")
        return (r.returncode, json.loads(r.stdout.strip().splitlines()[-1]),
                time.perf_counter() - t0)

    def cli_in_process(argv):
        import contextlib
        import io

        from shellac_tpu_torch import cli

        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        return (rc, json.loads(buf.getvalue().strip().splitlines()[-1]),
                time.perf_counter() - t0)

    def losses(path):
        return {json.loads(x)["step"]: json.loads(x)["loss"]
                for x in open(path) if '"loss"' in x}

    with tempfile.TemporaryDirectory() as tmp:
        conf = os.path.join(tmp, "cfg.json")
        with open(conf, "w") as f:
            json.dump({"preset": "shellac-1b", "n_layers": 2}, f)
        ck = os.path.join(tmp, "ck")
        common = ["--config", conf, "--seed", str(seed), "--batch", "2",
                  "--seq", "512"]
        train = ["train", *common, "--steps", "6", "--ckpt-dir", ck,
                 "--ckpt-every", "4", "--log-every", "1", "--warmup-steps",
                 "2"]
        whole_log, resumed_log = (os.path.join(tmp, "whole.jsonl"),
                                  os.path.join(tmp, "resumed.jsonl"))
        rc1, out1, s1 = run(train + ["--log-path", whole_log])
        whole = Checkpointer(ck).restore(device="cpu")
        steps = sorted(int(n) for n in os.listdir(ck) if n.isdigit())
        shutil.rmtree(os.path.join(ck, "6"))
        rc2, out2, s2 = run(train + ["--log-path", resumed_log])
        rc3, ev, s3 = cli_in_process(["eval", *common, "--ckpt-dir", ck,
                                      "--batches", "2"])
        resumed = Checkpointer(ck).restore(device="cpu")
        want, got = losses(whole_log), losses(resumed_log)
        worst = 0.0
        for (_, x), (_, y) in zip(named_leaves(resumed.params),
                                  named_leaves(whole.params)):
            scale = y.abs().max().clamp_min(1e-30)
            worst = max(worst, ((x - y).abs().max() / scale).item())
        loss_err = max(abs(got[k] - want[k]) / abs(want[k]) for k in got)
        ok = (rc1 == rc2 == rc3 == 0 and out1 == out2 == {"final_step": 6}
              and steps == [4, 6] and sorted(got) == [5, 6]
              and resumed.step == whole.step == 6 and loss_err <= 1e-3
              and worst <= 1e-3 and np.isfinite(ev["loss"])
              and ev["batches"] == 2)
        emit("cli-train", whole=out1, resumed=out2, checkpoints=steps,
             eval=ev, seconds=[s1, s2, s3],
             losses=[want[k] for k in sorted(want)],
             resumed_losses=[got[k] for k in sorted(got)],
             loss_max_rel_err=loss_err, params_max_err_over_scale=worst,
             bit_equal=worst == 0.0 and loss_err == 0.0,
             tol="losses 1e-3 rel, params 1e-3 of each leaf's max-abs",
             ok=ok, card=card)
        if not ok:
            raise SystemExit("cli-train: the resumed run does not match the "
                             "uninterrupted one, or a command failed")


# --------------------------------------------------------------------------
# beam search: beam, beam-parity, the kernels at the beam's shapes
# --------------------------------------------------------------------------

# One prompt, K beams (and K_WIDE on the pool), BEAM_NEW tokens.
BEAM_PROMPT, BEAM_K, BEAM_K_WIDE, BEAM_NEW = 512, 4, 16, 64
# The beam cache's length at those sizes: the bucket of 512 + 64.
BEAM_CACHE = 1024
# Step replays timed back to back (their writes stay inside the beam
# cache, or go to the blocks the search gave back).
BEAM_REPLAYS = 20
# The HTTP pass: streaming clients, their prompt and output lengths.
BEAM_STREAMS, BEAM_STREAM_PROMPT, BEAM_STREAM_NEW = 8, 256, 160


def cow_tables(gen, dev, bs, max_blocks, prompt, lengths, frozen):
    """Block tables as the copy-on-write beam search leaves them before a
    step: the prompt's sealed blocks shared by every live row, each live
    row's later blocks its own, except that row 1 shares row 0's sealed
    generated blocks (it adopted row 0's lineage), and the frozen rows'
    tables all block 0 (scratch) at their stale lengths. The step's query
    sits at `lengths`, so a length that is a multiple of bs attends the
    first position of a new block. Returns (tables, index, live, n_blocks),
    `live` (n_blocks, bs) marking the rows some row attends."""
    k = len(lengths)
    index = torch.tensor(lengths, dtype=torch.int32, device=dev)
    sealed = prompt // bs
    need = [-(-(n + 1) // bs) for n in lengths]
    n_blocks = 2 + sealed + sum(need) + 64
    ids = (torch.randperm(n_blocks - 1, generator=gen, device=dev)
           + 1).tolist()
    tables = torch.zeros((k, max_blocks), dtype=torch.int32, device=dev)
    row = ids[:sealed]
    at = sealed
    for b in range(k):
        if b in frozen:
            continue
        tables[b, :sealed] = torch.tensor(row, dtype=torch.int32)
        for j in range(sealed, need[b]):
            if b == 1 and j < min(need[0], need[1]) - 1:
                tables[1, j] = tables[0, j]
            else:
                tables[b, j] = ids[at]
                at += 1
    pos = torch.arange(max_blocks * bs, device=dev)[None, :]
    attended = pos < index[:, None].long() + 1
    pages = tables.long().gather(1, (pos // bs).expand(k, -1))
    live = torch.zeros((n_blocks, bs), dtype=torch.bool, device=dev)
    live[pages[attended], (pos % bs).expand(k, -1)[attended]] = True
    return tables, index, live, n_blocks


# The beam kernels' cases: name -> (kernel, K, block size, lengths,
# frozen rows). Dense: every beam at the last step's length, one frozen
# beam rolled back. Paged: lengths on both sides of a block boundary.
BEAM_KERNEL_CASES = {
    "dense_k4": ("dense", 4, None, [575, 575, 575, 540], ()),
    "dense_k16": ("dense", 16, None, [560] * 12 + [530, 560, 513, 560], ()),
    "paged_k4_cow": ("paged", 4, BLOCK, [528, 528, 527, 520], (3,)),
    "paged_k16_cow": ("paged", 16, BLOCK,
                      [543, 543, 544, 544] * 3 + [544, 520, 544, 543],
                      (13,)),
    "paged_int8_k4_cow": ("paged", 4, BLOCK_INT8, [576, 576, 575, 540],
                          (3,)),
}


def phase_kernels_beam(gen, dev):
    """Kernels 5 and 6 over a beam cache (B = K, length BEAM_CACHE, rows
    0 and 1 equal as after a reorder), and kernel 7 in bf16 and int8 over
    copy-on-write tables (`cow_tables`), each against its plain version,
    in bf16 and fp32. The paged kernel reads pools (or int8 scales) whose
    rows no beam attends are NaN, the plain version the clean ones."""
    from shellac_tpu_torch.ops.decode_attention import (
        _decode_ref,
        _paged_decode_ref,
        decode_attention_cuda,
        decode_attention_quant_cuda,
        paged_decode_attention_cuda,
        paged_decode_attention_quant_cuda,
    )

    failed = []
    h, hkv, d = 16, 8, 128
    scale = d ** -0.5
    for dtype in (torch.bfloat16, torch.float32):
        for case, (kind, k, bs, lengths, frozen) in \
                BEAM_KERNEL_CASES.items():
            int8 = bs == BLOCK_INT8
            q = randn(gen, (k, 1, h, d), dtype, dev)
            if kind == "dense":
                idx = torch.tensor(lengths, dtype=torch.int32, device=dev)
                ck = randn(gen, (k, hkv, BEAM_CACHE, d), dtype, dev)
                cv = randn(gen, (k, hkv, BEAM_CACHE, d), dtype, dev)
                ck[1], cv[1] = ck[0], cv[0]
                out = decode_attention_cuda(q, ck, cv, idx)
                ref = _decode_ref(q, ck, cv, idx, None, scale)
                res = [("decode_attention_dense", out, ref)]
                qk, sk = quant_rows(gen, (k, hkv, BEAM_CACHE, d), dev)
                qv, sv = quant_rows(gen, (k, hkv, BEAM_CACHE, d), dev)
                res.append(("decode_attention_dense_int8",
                            decode_attention_quant_cuda(q, qk, qv, sk, sv,
                                                        idx),
                            _decode_ref(q, qk, qv, idx, None, scale,
                                        k_scale=sk, v_scale=sv)))
            else:
                tab, idx, live, nb = cow_tables(
                    gen, dev, bs, MAX_LEN // bs, BEAM_PROMPT, lengths,
                    frozen)
                dead = ~live[:, None, :].expand(nb, hkv, bs)
                if int8:
                    pk, sk = quant_rows(gen, (nb, hkv, bs, d), dev)
                    pv, sv = quant_rows(gen, (nb, hkv, bs, d), dev)
                    out = paged_decode_attention_quant_cuda(
                        q, pk, pv, sk.masked_fill(dead, float("nan")),
                        sv.masked_fill(dead, float("nan")), tab, idx)
                    ref = _paged_decode_ref(q, pk, pv, tab, idx, None, scale,
                                            k_scale=sk, v_scale=sv)
                    res = [("paged_decode_attention_int8", out, ref)]
                else:
                    pk = randn(gen, (nb, hkv, bs, d), dtype, dev)
                    pv = randn(gen, (nb, hkv, bs, d), dtype, dev)
                    out = paged_decode_attention_cuda(
                        q, pk.masked_fill(dead[..., None], float("nan")),
                        pv.masked_fill(dead[..., None], float("nan")), tab,
                        idx)
                    ref = _paged_decode_ref(q, pk, pv, tab, idx, None, scale)
                    res = [("paged_decode_attention", out, ref)]
            for kernel, out, ref in res:
                torch.cuda.synchronize()
                r = compare(out, ref, dtype)
                emit("kernels-beam", kernel=kernel, case=case,
                     dtype=str(dtype), beams=k, block_size=bs,
                     lengths=lengths, frozen_rows=list(frozen), **r)
                if not r["ok"]:
                    failed.append((kernel, case, str(dtype)))
    if failed:
        raise SystemExit(f"kernels-beam: kernels disagree with their plain "
                         f"versions over the beam's shapes: {failed}")


def beam_engine(cfg, params, dev, backend, **kw):
    """The server's engine of a cache: a BatchingEngine (its beam search
    the single-request delegate) or a PagedBatchingEngine (copy-on-write
    over its pool), at serve's slots and max_len."""
    from shellac_tpu_torch.inference.batching import (
        BatchingEngine,
        PagedBatchingEngine,
    )

    cls = (PagedBatchingEngine if backend.startswith("paged")
           else BatchingEngine)
    return cls(cfg, params, n_slots=SLOTS, max_len=MAX_LEN,
               cache_backend=backend, temperature=0.0, device=dev, **kw)


def timed_search(eng, prompt, k, steps, **kw):
    """One beam search: (sequences, scores, wall ms on the host, ms
    between CUDA events around it, graphs captured)."""
    from shellac_tpu_torch.inference.graphs import StepGraph

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    captured = StepGraph.captures
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    seqs, scores = eng.beam_search(prompt, num_beams=k, max_new_tokens=steps,
                                   **kw)
    end.record()
    torch.cuda.synchronize()
    return dict(seqs=seqs, scores=scores,
                wall_ms=(time.perf_counter() - t0) * 1e3,
                event_ms=start.elapsed_time(end),
                captured=StepGraph.captures - captured)


def beam_launches(table, L, backend, searches, steps, prefix=False):
    """Launches of `searches` searches of `steps` tokens: per search 2L + 1
    RMSNorms a prefill and a step, L flash forwards (none on a prefix
    hit, whose suffix attends through the plain attention), L decode
    attentions a step after the first token."""
    return only(table, rms_norm=(2 * L + 1) * steps * searches,
                flash_attention_fwd=0 if prefix else L * searches,
                **{DECODE_KERNEL[backend]: L * (steps - 1) * searches})


def gather_copy_ms(prof):
    """Device ms of a profile's gathers, scatters and copies (the row
    reorder, the copy-on-write, the state copies), from its top rows."""
    return sum(r["ms"] for r in prof["top"]
               if any(t in r["kernel"].lower()
                      for t in ("index", "copy", "gather", "scatter")))


def beam_pass(eng, table, L, backend, prompt, k, card, name, prefix=False,
              profiled=False):
    """One cache's pass of phase `beam`: a first search (it captures the
    prefill graph after an eager warm-up, and the step graph), a second
    (it must capture none and give the same beams), a one-step search
    over the same programs; the ms a step between the events of a search
    (second minus one-step, over BEAM_NEW - 1: the host's gaps
    included), the device ms of a step (the key's step graph replayed
    BEAM_REPLAYS times back to back after the searches, on their last
    state: the host only queues), with `profiled` one profiled search
    (device ms by kind, the gathers and copies apart), exact launch
    counts, peak memory and the pool blocks borrowed."""
    be = eng.cache_backend
    reset_peak()
    if be.is_paged:
        be.peak_blocks_used = be.blocks_used()
    before = read_counts(table)
    first = timed_search(eng, prompt, k, BEAM_NEW)
    second = timed_search(eng, prompt, k, BEAM_NEW)
    one = timed_search(eng, prompt, k, 1)
    counts = {n: c - before[n] for n, c in read_counts(table).items()}
    # Two whole searches, then the one-step search's prefill and the
    # first search's prefill warm-up (before its capture).
    expect = beam_launches(table, L, backend, 2, BEAM_NEW, prefix)
    expect = {n: expect[n] + beam_launches(table, L, backend, 2, 1,
                                           prefix)[n] for n in expect}
    peak = torch.cuda.max_memory_allocated() / 2**30
    beams = (eng._beam_delegate._beams if eng._beam_delegate is not None
             else eng._beams)
    step = next(reversed(beams.values())).step
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.inference_mode():  # Engine's beam buffers are its tensors
        start.record()
        for _ in range(BEAM_REPLAYS):
            step()
        end.record()
    torch.cuda.synchronize()
    step_device_ms = start.elapsed_time(end) / BEAM_REPLAYS
    prof = {}
    if profiled:
        p = profile_call(lambda: eng.beam_search(
            prompt, num_beams=k, max_new_tokens=BEAM_NEW), top=40)
        prof = dict(profiled_search_device_ms=p["device_ms"],
                    profiled_search_busy_share=p["device_busy_share"],
                    profiled_device_ms_by_kind=p["device_ms_by_kind"],
                    profiled_gather_copy_ms=gather_copy_ms(p),
                    profiled_trace_lost=p["trace_lost"],
                    profiled_top=p["top"][:12])
    step_ms = (second["event_ms"] - one["event_ms"]) / (BEAM_NEW - 1)
    scores = second["scores"]
    ok = (first["seqs"] == second["seqs"] and first["scores"] == scores
          and len(scores) == k and all(np.isfinite(scores))
          and scores == sorted(scores, reverse=True)
          and all(len(q) == BEAM_NEW for q in second["seqs"])
          and first["captured"] == 2 and second["captured"] == 0
          and one["captured"] == 0 and counts == expect)
    emit("beam", pass_name=name, backend=backend, beams=k,
         prompt=len(prompt), new_tokens=BEAM_NEW, length_penalty=1.0,
         search_wall_ms=[first["wall_ms"], second["wall_ms"]],
         one_step_search_wall_ms=one["wall_ms"],
         step_ms_between_events=step_ms, step_device_ms=step_device_ms,
         **prof,
         graphs_captured=[first["captured"], second["captured"],
                          one["captured"]],
         peak_memory_gib=peak,
         pool_blocks_borrowed=(be.peak_blocks_used - be.blocks_used()
                               if be.is_paged else None),
         launches=counts, launches_expected=expect,
         scores=scores, top_beam=second["seqs"][0][:16], ok=ok, card=card)
    return ok, second


def beam_http(cfg, params, dev, card, prompt):
    """phase `beam`'s HTTP pass: InferenceServer over the paged engine
    with serve's scheduling (PIPELINED, one tick a window) and the byte
    tokenizer; BEAM_STREAMS streaming /generate clients, run once to warm
    the graphs, once alone and once beside a num_beams = 4 /generate
    request and a num_beams = 4 /v1/completions request under a
    json_schema response_format (sent once every stream has its first
    token). The beams must equal the in-process engine's (searched
    before the server starts), every constrained beam parse and obey the
    schema. Returns (the names of the failed checks, its counts)."""
    import threading

    from shellac_tpu_torch.inference.batching import PagedBatchingEngine
    from shellac_tpu_torch.inference.constraints import (
        compile_token_dfa,
        constraint_pattern,
    )
    from shellac_tpu_torch.inference.server import (
        InferenceServer,
        make_http_server,
    )
    from shellac_tpu_torch.obs import Registry
    from shellac_tpu_torch.training.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    engine = PagedBatchingEngine(
        cfg, params, n_slots=SLOTS, max_len=MAX_LEN, block_size=BLOCK,
        decode_ticks=1, temperature=0.0, eos_id=EOS_BYTE, device=dev,
        **PIPELINED)
    text = "the weather, as json: "
    ctoks = [int(t) for t in tok.encode(text)]
    dfa = compile_token_dfa(constraint_pattern({"json_schema": CON_SCHEMA}),
                            tok, cfg.vocab_size, EOS_BYTE)
    want = engine.beam_search(prompt, num_beams=BEAM_K,
                              max_new_tokens=BEAM_NEW, eos_id=EOS_BYTE)
    want_con = engine.beam_search(ctoks, num_beams=BEAM_K,
                                  max_new_tokens=96, constraint=dfa)
    srv = InferenceServer(cfg, params, tokenizer=tok, engine=engine,
                          model_name="shellac-1b", registry=Registry())
    httpd = make_http_server(srv)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    rng = np.random.default_rng(77)
    streams = [rng.integers(0, 256, BEAM_STREAM_PROMPT).tolist()
               for _ in range(BEAM_STREAMS)]

    def streamed(toks, new, out, started):
        import urllib.request

        req = urllib.request.Request(
            url + "/generate", data=json.dumps(
                {"tokens": toks, "max_new": new, "stream": True}).encode(),
            headers={"Content-Type": "application/json"})
        times, n = [], 0
        with urllib.request.urlopen(req, timeout=600) as r:
            for raw in r:
                rec = json.loads(raw)
                if rec.get("tokens") and not rec.get("done"):
                    times.append(time.perf_counter())
                    n += len(rec["tokens"])
                    started.set()
        out.append((times, n))

    def run(with_beams, new=BEAM_STREAM_NEW):
        outs, threads, flags = [], [], []
        for toks in streams:
            ev = threading.Event()
            th = threading.Thread(target=streamed,
                                  args=(toks, new, outs, ev))
            th.start()
            threads.append(th)
            flags.append(ev)
        beams = {}
        if with_beams:
            for ev in flags:
                ev.wait(120)
            beams["generate"] = http_call(url, "/generate", {
                "tokens": [int(t) for t in prompt], "num_beams": BEAM_K,
                "max_new": BEAM_NEW})
            beams["completions"] = http_call(url, "/v1/completions", {
                "prompt": text, "num_beams": BEAM_K, "max_tokens": 96,
                "response_format": {"type": "json_schema", "json_schema": {
                    "name": "w", "schema": CON_SCHEMA}}})
        for th in threads:
            th.join(600)
        tpot = [(t[-1] - t[0]) * 1e3 / max(n - 1, 1) for t, n in outs]
        gaps = [b - a for t, _ in outs for a, b in zip(t, t[1:])]
        return beams, dict(
            streams=len(outs), tpot_ms_p50=pct(tpot, 50),
            tpot_ms_p99=pct(tpot, 99),
            chunk_gap_ms_p99=pct(gaps, 99) * 1e3 if gaps else None,
            chunk_gap_ms_max=max(gaps) * 1e3 if gaps else None)

    failed = []
    try:
        run(False, 8)  # the warm-up: the prefill bucket and window graphs
        _, alone = run(False)
        beams, beside = run(True)
    finally:
        httpd.shutdown()
        srv.close()
    status, _, body, _ = beams["generate"]
    got = json.loads(body) if status == 200 else {}
    gen_ok = (status == 200
              and [c["tokens"] for c in got["choices"]] == want[0]
              and [c["beam_score"] for c in got["choices"]]
              == [round(x, 6) for x in want[1]])
    status, _, body, _ = beams["completions"]
    got = json.loads(body) if status == 200 else {}
    texts = [c["text"] for c in got.get("choices", [])]
    con_ok = (status == 200 and texts == [tok.decode(q) for q in want_con[0]]
              and len(texts) > 0)
    parsed = []
    for q in want_con[0]:
        try:
            parsed.append(q[-1] == EOS_BYTE
                          and schema_ok(json.loads(bytes(q[:-1]).decode())))
        except ValueError:
            parsed.append(False)
    con_ok = con_ok and all(parsed)
    if not gen_ok:
        failed.append("http:generate")
    if not con_ok:
        failed.append("http:completions_json_schema")
    if not (alone["streams"] == beside["streams"] == BEAM_STREAMS):
        failed.append("http:streams")
    emit("beam", pass_name="http", streams=BEAM_STREAMS,
         stream_prompt=BEAM_STREAM_PROMPT, stream_new=BEAM_STREAM_NEW,
         without_beams=alone, with_beams=beside,
         generate_beams_equal_engine=gen_ok,
         constrained_beams_equal_engine=con_ok,
         constrained_beams=len(want_con[0]),
         constrained_beams_parse_and_obey=parsed,
         constrained_top=tok.decode(want_con[0][0]) if want_con[0] else None,
         card=card)
    return failed


def phase_beam(seed, dev, table, card):
    """Beam search at full width (shellac-1b, random weights): one
    BEAM_PROMPT-token prompt, K = 4, BEAM_NEW tokens, length penalty 1,
    through each cache's serving engine (`beam_pass`): dense, dense-int8,
    paged, paged-int8; on paged also K = 16 and a prefix-hit pass (a
    cached 496-token prefix attached read-only). Whether dense and paged
    (and their int8 twins) agree on the top beam is reported: their bf16
    kernels sum in other orders. Then the HTTP pass (`beam_http`).
    Returns the launch counts of the phase."""
    from shellac_tpu_torch import get_model_config
    from shellac_tpu_torch.models import transformer

    t0 = time.perf_counter()
    cfg = get_model_config("shellac-1b")
    params = transformer.init_params(cfg, seed=seed, device=dev)
    L = cfg.n_layers
    prompt = np.random.default_rng(seed + 41).integers(
        0, cfg.vocab_size, BEAM_PROMPT).astype(np.int32)
    reset_counts(table)
    failed, tops = [], {}
    for backend in ("dense", "dense-int8", "paged", "paged-int8"):
        eng = beam_engine(cfg, params, dev, backend)
        ok, res = beam_pass(eng, table, L, backend, prompt, BEAM_K, card,
                            backend, profiled=backend in ("dense", "paged"))
        tops[backend] = res
        if not ok:
            failed.append(backend)
        if backend == "paged":
            ok, _ = beam_pass(eng, table, L, backend, prompt, BEAM_K_WIDE,
                              card, "paged_k16")
            if not ok:
                failed.append("paged_k16")
        eng.close()
        del eng
    eng = beam_engine(cfg, params, dev, "paged", prefix_cache=True)
    cached = BEAM_PROMPT - BLOCK  # 31 blocks registered
    eng.run([("seed", prompt[:cached + 1], 1)])
    before = dict(eng.stats)
    ok, res = beam_pass(eng, table, L, "paged", prompt, BEAM_K, card,
                        "paged_prefix_hit", prefix=True)
    hit = eng.stats["prefix_hit_tokens"] - before["prefix_hit_tokens"]
    searches = (eng.stats["prefix_query_tokens"]
                - before["prefix_query_tokens"]) // BEAM_PROMPT
    emit("beam", pass_name="paged_prefix_hit", prefix_hit_tokens=hit,
         searches=searches, top_beam_equal_uncached=(
             res["seqs"][0] == tops["paged"]["seqs"][0]), card=card)
    if not ok or searches != 3 or hit != searches * cached:
        failed.append("paged_prefix_hit")
    eng.close()
    del eng
    emit("beam", pass_name="agreement",
         top_beam_dense_equals_paged=(tops["dense"]["seqs"][0]
                                      == tops["paged"]["seqs"][0]),
         top_beam_dense_int8_equals_paged_int8=(
             tops["dense-int8"]["seqs"][0] == tops["paged-int8"]["seqs"][0]),
         beams_dense_equal_paged=tops["dense"]["seqs"]
         == tops["paged"]["seqs"],
         top_score_dense_minus_paged=(tops["dense"]["scores"][0]
                                      - tops["paged"]["scores"][0]),
         card=card)
    failed += beam_http(cfg, params, dev, card, prompt)
    emit("beam", pass_name="done", seconds=time.perf_counter() - t0)
    counts = read_counts(table)
    del params
    reset_peak()
    if failed:
        raise SystemExit(f"beam: checks failed: {failed}")
    return counts


def plain_kernels():
    """A context in which the model's RMSNorm takes its plain version (the
    attention's is attn_impl="ref"): beam-parity's plain searches."""
    import contextlib

    from shellac_tpu_torch.models import transformer
    from shellac_tpu_torch.ops.norms import rms_norm_ref

    @contextlib.contextmanager
    def ctx():
        kernel = transformer.rms_norm
        transformer.rms_norm = rms_norm_ref
        try:
            yield
        finally:
            transformer.rms_norm = kernel
    return ctx()


def phase_beam_parity(seed, dev, table):
    """Beam search at shellac-1b width cut to 2 layers in fp32: through
    the kernels against the same search with every kernel swapped for
    its plain version (attn_impl="ref", RMSNorm's plain version), over
    the four caches: equal sequences and scores within 1e-4, and the
    plain searches launch no kernel. Dense against paged, and dense-int8
    against paged-int8 (the reference's bit-exact claim), reported."""
    from shellac_tpu_torch import get_model_config
    from shellac_tpu_torch.models import transformer

    t0 = time.perf_counter()
    cfg = get_model_config("shellac-1b").replace(n_layers=2, dtype="float32")
    params = transformer.init_params(cfg, seed=seed, device=dev)
    prompt = np.random.default_rng(seed + 42).integers(
        0, cfg.vocab_size, BEAM_PROMPT).astype(np.int32)
    got, failed = {}, []
    for backend in ("dense", "dense-int8", "paged", "paged-int8"):
        res = {}
        for impl in ("auto", "ref"):
            eng = beam_engine(cfg, params, dev, backend, attn_impl=impl)
            reset_counts(table)
            if impl == "ref":
                with plain_kernels():
                    res[impl] = eng.beam_search(
                        prompt, num_beams=BEAM_K, max_new_tokens=BEAM_NEW)
            else:
                res[impl] = eng.beam_search(prompt, num_beams=BEAM_K,
                                            max_new_tokens=BEAM_NEW)
            res[impl + "_launches"] = sum(read_counts(table).values())
            eng.close()
            del eng
        diff = float(np.max(np.abs(np.subtract(res["auto"][1],
                                               res["ref"][1]))))
        ok = (res["auto"][0] == res["ref"][0] and diff <= 1e-4
              and res["ref_launches"] == 0 and res["auto_launches"] > 0)
        emit("beam-parity", backend=backend, layers=2, dtype="float32",
             beams=BEAM_K, new_tokens=BEAM_NEW,
             sequences_equal=res["auto"][0] == res["ref"][0],
             max_score_diff=diff, plain_launches=res["ref_launches"],
             kernel_launches=res["auto_launches"], ok=ok)
        got[backend] = res["auto"]
        if not ok:
            failed.append(backend)
    for a, b in (("dense", "paged"), ("dense-int8", "paged-int8")):
        emit("beam-parity", pair=[a, b],
             sequences_equal=got[a][0] == got[b][0],
             scores_bit_equal=got[a][1] == got[b][1],
             max_score_diff=float(np.max(np.abs(np.subtract(got[a][1],
                                                            got[b][1])))))
    emit("beam-parity", seconds=time.perf_counter() - t0)
    del params
    torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"beam-parity: kernels and plain versions give "
                         f"other beams: {failed}")


def beam_graph_parity(cfg, params, dev, table, cls, backend, seed):
    """graph-parity's beam pass over one cache: constrained (CON_REGEX) and
    not, K = 1 and 4, a search of 24 tokens through the engine's CUDA
    graphs (the prefill's eager warm-up, capture and replay, the step's
    first run eager, then 22 replays) against the same search on an
    engine whose programs run eagerly: bit-equal beams and scores, and
    the eager launches plus the warm-up prefill's. Returns the failed
    runs."""
    from shellac_tpu_torch.inference.constraints import compile_token_dfa
    from shellac_tpu_torch.training.tokenizer import ByteTokenizer

    dfa = compile_token_dfa(CON_REGEX, ByteTokenizer(), cfg.vocab_size,
                            EOS_BYTE)
    prompt = np.random.default_rng(seed + 43).integers(
        0, 256, 200).astype(np.int32)
    failed = []
    for con in (False, True):
        for k in (1, BEAM_K):
            runs = {}
            for name, c in (("graph", cls), ("eager", eager_engine(cls))):
                eng = c(cfg, params, n_slots=6, max_len=512,
                        cache_backend=backend, eos_id=EOS_BYTE, device=dev)
                reset_counts(table)
                out = eng.beam_search(prompt, num_beams=k,
                                      max_new_tokens=24,
                                      constraint=dfa if con else None)
                torch.cuda.synchronize()
                runs[name] = (out, read_counts(table))
                eng.close()
                del eng
            # The graph engine's first search warms its prefill up once
            # before capturing it: one prefill's launches more.
            warm = beam_launches(table, cfg.n_layers, backend, 1, 1)
            ok = (runs["graph"][0] == runs["eager"][0]
                  and runs["graph"][1] == {n: c + warm[n] for n, c in
                                           runs["eager"][1].items()})
            emit("graph-parity", backend=backend, pass_name="beam",
                 constrained=con, beams=k, new_tokens=24,
                 layers=2, dtype="bfloat16",
                 beams_identical_to_eager=runs["graph"][0]
                 == runs["eager"][0],
                 launches=runs["graph"][1],
                 launches_eager=runs["eager"][1], ok=ok)
            if not ok:
                failed.append((backend, "beam", con, k))
    return failed


# --------------------------------------------------------------------------
# MoE: moe (GPT-OSS-20B's shape), moe-parity, graph-parity-moe, kernels-moe
# --------------------------------------------------------------------------

# GPT-OSS's attention shape: 64 q heads over 8 kv heads of 64, a 128-token
# window on alternate layers, sinks on every layer.
GPTOSS_HEADS, GPTOSS_KV_HEADS, GPTOSS_HEAD_DIM, GPTOSS_WINDOW = 64, 8, 64, 128


# The published `openai/gpt-oss-20b` config.json, the keys that define its
# shape (its MXFP4 quantization_config is left out: the phases make bf16
# weights from --seed).
GPTOSS_20B_HF = {
    "architectures": ["GptOssForCausalLM"], "model_type": "gpt_oss",
    "vocab_size": 201088, "hidden_size": 2880, "intermediate_size": 2880,
    "num_hidden_layers": 24, "num_attention_heads": 64,
    "num_key_value_heads": 8, "head_dim": 64, "num_local_experts": 32,
    "num_experts_per_tok": 4, "experts_per_token": 4, "sliding_window": 128,
    "layer_types": ["sliding_attention", "full_attention"] * 12,
    "max_position_embeddings": 131072, "initial_context_length": 4096,
    "rope_theta": 150000, "rope_scaling": {
        "rope_type": "yarn", "factor": 32.0, "beta_fast": 32.0,
        "beta_slow": 1.0, "truncate": False,
        "original_max_position_embeddings": 4096},
    "rms_norm_eps": 1e-05, "tie_word_embeddings": False,
    "attention_bias": True, "router_aux_loss_coef": 0.9,
    "swiglu_limit": 7.0, "hidden_act": "silu", "torch_dtype": "bfloat16",
}


def gptoss_20b():
    """GPT-OSS-20B: the published config's keys (GPTOSS_20B_HF: 24 layers,
    hidden 2880, 64 q heads over 8 kv heads of 64, 32 experts, 4 a token,
    of width 2880, vocab 201088, a 128-token sliding window on the even
    layers, yarn rope of factor 32 over 4096 positions without truncation,
    theta 150000, RMS eps 1e-5, untied embeddings, router aux coefficient
    0.9) through the port's mapping (`models/convert.py`
    `config_from_hf`): sinks, q/k/v/o biases, the softmax-after-top-k
    gate with biased experts, the clamped (up + 1) * glu activation,
    dropless routing; no remat (serving). 20.9 B parameters."""
    from shellac_tpu_torch.models.convert import HFConfig, config_from_hf

    return config_from_hf(HFConfig(GPTOSS_20B_HF)).replace(remat=False)


def moe_step_profile(cfg, params, tok, cache):
    """Device ms of one cached forward (a decode step at tok's rows) by
    kernel kind (`profile_call`: the port's kernels, GEMMs, the rest),
    and of one of its MoE layers' experts called alone at the same rows
    as the cached forward runs them (`transformer.moe_experts`): the
    GEMMs (the experts' products and the router's) and every other
    kernel (routing, dispatch, the activation and the combine), with the
    number of MoE layers a step runs."""
    from shellac_tpu_torch.models import transformer

    def step():
        return transformer.forward_with_cache(cfg, params, tok, cache)

    step()
    torch.cuda.synchronize()
    out = profile_call(step)
    layer = next(i for i, f in enumerate(transformer.moe_layers(cfg)) if f)
    lp = params["layers"][layer]
    g = torch.Generator(device=tok.device)
    g.manual_seed(tok.shape[0])
    hx = randn(g, (tok.shape[0], 1, cfg.d_model), cfg.compute_dtype,
               tok.device)

    def ffn():
        return transformer.moe_experts(cfg, hx, lp, cached=True)

    ffn()
    torch.cuda.synchronize()
    one = profile_call(ffn)
    kinds = one["device_ms_by_kind"]
    out["moe_layer"] = {
        "layers": sum(transformer.moe_layers(cfg)),
        "device_ms": one["device_ms"], "launches": one["launches"],
        "trace_lost": one["trace_lost"],
        "gemm_ms": kinds.get("gemm", 0.0),
        "routing_dispatch_activation_combine_ms": kinds.get("other", 0.0),
        "top": one["top"][:6]}
    return out


def moe_choices(cfg, params, cur, cache, impl, pinned=None):
    """One cached forward of `cur` (B, 1) over `cache` through attn_impl
    `impl`: its logits (B, V) and, per MoE layer, each row's chosen
    experts (B, k) and the gap between its k-th and (k+1)-th router
    logit. With `pinned` (layers, B, k) each layer takes those experts
    instead of its own choice, weighted as its gate weighs them: the
    softmax of its own logits over them (GPT-OSS's softmax-after-top-k
    gate), or their own softmax probabilities times the routed scale
    (DeepSeek-V2's softmax gate, ungrouped). Writes each row's k/v at its
    length, which the next real step overwrites."""
    from shellac_tpu_torch.models import transformer
    from shellac_tpu_torch.ops import moe
    from shellac_tpu_torch.ops.sampling import top_k

    if cfg.moe.scoring not in ("softmax_topk", "softmax") \
            or cfg.moe.n_group > 1:
        raise ValueError("moe_choices pins the softmax_topk and ungrouped "
                         "softmax gates only")
    chosen, gaps = [], []
    inner = moe._route_scores

    def recording(x, w_router, m, b_router=None, aux=True):
        idx, weight, a, mets = inner(x, w_router, m, b_router, aux)
        logits = x.float() @ w_router.float()
        if m.scoring == "softmax_topk":
            logits = logits + b_router.float()
            sel = logits
        else:
            sel = torch.softmax(logits, dim=-1)
        top = top_k(sel, m.num_experts_per_token + 1)[0]
        gaps.append(top[:, -2] - top[:, -1])
        chosen.append(idx)
        if pinned is not None:
            idx = pinned[len(chosen) - 1]
            if m.scoring == "softmax_topk":
                weight = torch.softmax(logits.gather(-1, idx), dim=-1)
            else:
                weight = sel.gather(-1, idx)
                if m.norm_topk_prob:
                    weight = weight / weight.sum(dim=-1, keepdim=True)
            weight = weight * m.routed_scaling_factor
        return idx, weight, a, mets

    moe._route_scores = recording
    try:
        with torch.inference_mode():
            logits, _ = transformer.forward_with_cache(
                cfg, params, cur, cache, attn_impl=impl)
    finally:
        moe._route_scores = inner
    return logits[:, 0], torch.stack(chosen), torch.stack(gaps)


def check_moe_decode_logits(phase, cfg, params, engine):
    """check_decode_logits for an MoE model in bf16 at depth: the decode
    step's logits through the kernels against attn_impl="ref" on the same
    cache state. Their attention outputs differ by bf16 rounding, which
    can move a router logit past its neighbour where the k-th and
    (k+1)-th are close; a row whose experts differ computes another
    function from that layer on. So the plain run takes the kernel run's
    experts at every layer (weighted by its own logits), and every active
    row must agree within 5e-2 of the logits' scale (generate's and
    serve's rule); how many rows' own choices differ, at which layer
    first and by what gap, is printed."""
    act = [i for i, r in enumerate(engine._slots) if r is not None]
    cur = engine._cur[:, None]
    got, chosen, _ = moe_choices(cfg, params, cur, engine._cache, "auto")
    _, own, gap = moe_choices(cfg, params, cur, engine._cache, "ref")
    ref, _, _ = moe_choices(cfg, params, cur, engine._cache, "ref",
                            pinned=chosen)
    same = (chosen.sort(dim=-1).values == own.sort(dim=-1).values).all(-1)
    flipped = []
    for a in act:
        if not bool(same[:, a].all()):
            layer = int((~same[:, a]).nonzero()[0])
            flipped.append({"slot": a, "first_layer": layer,
                            "ref_gap": gap[layer, a].item()})
    scale = ref[act].abs().max().item()
    err = (got[act] - ref[act]).abs().max().item()
    ok = (len(act) > 0 and bool(torch.isfinite(got[act]).all().item())
          and err <= 5e-2 * scale)
    agree = int((got[act].argmax(-1) == ref[act].argmax(-1)).sum().item())
    emit(phase, step="decode_logits_kernel_vs_ref", active_slots=len(act),
         shape=list(got[act].shape), max_abs_err=err, ref_max_abs=scale,
         tol="max_abs_err <= 5e-2 * max|ref|, the plain run on the kernel "
         "run's experts", argmax_agree=agree,
         rows_whose_own_experts_differ=flipped, ok=ok)
    if not ok:
        raise SystemExit(f"{phase}: decode logits through the kernels "
                         "disagree with the plain path")


def moe_prefill_paths(cfg, params, dev, rows):
    """One MoE layer on a fresh prefill of `rows` tokens, bf16: the
    reference's capacity buckets at C = T (E * T rows through the
    experts) against the sorted-segment grouped product that the port
    serves dropless bf16 calls with (`moe_ffn_grouped`, T * k rows,
    `torch._grouped_mm` with device offsets), which computes the same
    function: the ms of each (CUDA events around eager calls) and their
    largest difference over the output's scale."""
    from shellac_tpu_torch.models import transformer
    from shellac_tpu_torch.ops.moe import moe_ffn, moe_ffn_grouped

    m = cfg.moe
    layer = next(i for i, f in enumerate(transformer.moe_layers(cfg)) if f)
    lp = params["layers"][layer]
    kw = dict(b_router=lp.get("b_router"), b_gate=lp.get("b_gate"),
              b_up=lp.get("b_up"), b_down=lp.get("b_down"), aux=False)
    g = torch.Generator(device=dev)
    g.manual_seed(rows)
    hx = randn(g, (1, rows, cfg.d_model), cfg.compute_dtype, dev)
    args = (hx, lp["w_router"], lp["w_gate"], lp["w_up"], lp["w_down"], m)
    out = {"rows": rows,
           "buckets_ms": eager_ms(lambda: moe_ffn(*args, drop_tokens=False,
                                                  **kw), [()], 5)}
    want = moe_ffn(*args, drop_tokens=False, **kw)[0].float()
    out["grouped_ms"] = eager_ms(lambda: moe_ffn_grouped(*args, **kw),
                                 [()], 5)
    got = moe_ffn_grouped(*args, **kw)[0].float()
    out["max_diff_over_scale"] = ((got - want).abs().max()
                                  / want.abs().max()).item()
    return out


def phase_moe(seed, dev, table, card):
    """GPT-OSS-20B's shape at full width and depth (random weights from
    --seed, made on the card layer by layer): Engine.generate at
    generate's shape, then PagedBatchingEngine on serve's requests under
    the reference serve's scheduling. Returns the launch counts of both
    runs together."""
    from shellac_tpu_torch import Engine
    from shellac_tpu_torch.inference.batching import PagedBatchingEngine
    from shellac_tpu_torch.inference.cache import init_cache
    from shellac_tpu_torch.inference.graphs import StepGraph
    from shellac_tpu_torch.models import transformer
    from shellac_tpu_torch.obs import Registry

    reset_peak()
    cfg = gptoss_20b()
    L = cfg.n_layers
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    emit("moe", step="init_params", model="gpt-oss-20b",
         params=transformer.num_params(params),
         weight_bytes=torch.cuda.memory_allocated(),
         seconds=time.perf_counter() - t0, card=card)

    # Engine.generate: 8 prompts padded to 512, 64 new tokens, greedy.
    toks, lens = prompts(seed, cfg.vocab_size, dev)
    engine = Engine(cfg, params, max_len=MAX_LEN, temperature=0.0,
                    device=dev)
    captured = StepGraph.captures
    # Warm-up: the first call runs both programs eagerly and captures the
    # step, the second captures the prefill.
    for _ in range(2):
        engine.generate(toks, lens, max_new_tokens=4)
    torch.cuda.synchronize()
    warm_captures = StepGraph.captures - captured
    reset_peak()
    reset_counts(table)
    captured = StepGraph.captures
    t0 = time.perf_counter()
    res = engine.generate(toks, lens, max_new_tokens=NEW_TOKENS)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    gen_counts = read_counts(table)
    captured = StepGraph.captures - captured
    peak = torch.cuda.max_memory_allocated()
    expect = only(table, rms_norm=(2 * L + 1) * NEW_TOKENS,
                  flash_attention_fwd=L,
                  decode_attention_dense=L * (NEW_TOKENS - 1))
    tokens_ok = (tuple(res.tokens.shape) == (PROMPTS, NEW_TOKENS)
                 and bool(((res.tokens >= 0)
                           & (res.tokens < cfg.vocab_size)).all().item())
                 and bool(torch.isfinite(res.logprobs).all().item()))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one = engine.generate(toks, lens, max_new_tokens=1)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    tokens_ok = tokens_ok and bool(torch.equal(one.tokens[:, 0],
                                               res.tokens[:, 0]))
    with torch.inference_mode():
        _, cache, _ = engine._prefill_impl(toks, lens)
        tok = res.tokens[:, :1].long()
        step_ms = graph_ms(
            lambda: transformer.forward_with_cache(cfg, params, tok, cache),
            [()], 1)
        by_kind = moe_step_profile(cfg, params, tok, cache)
    emit("moe", step="generate", model="gpt-oss-20b", prompts=PROMPTS,
         pad=PAD, new_tokens=NEW_TOKENS, launches=gen_counts,
         expected=expect, tokens_ok=tokens_ok, total_s=total_s,
         tokens_per_s=PROMPTS * NEW_TOKENS / total_s,
         prefill_wall_ms=prefill_ms,
         decode_ms_per_token=(total_s * 1e3 - prefill_ms) / (NEW_TOKENS - 1),
         decode_step_device_ms=step_ms, decode_step_by_kind=by_kind,
         graphs_captured={"warm_up": warm_captures, "timed": captured},
         max_memory_allocated=peak, card=card)
    if gen_counts != expect or not tokens_ok or captured != 0:
        raise SystemExit("moe generate: wrong launch counts, bad tokens or "
                         "a capture in the timed call")
    del engine, cache, res, one
    reset_peak()

    # A fresh 1024-token prefill (serve's largest bucket), its device ms.
    with torch.inference_mode():
        ptoks = torch.randint(0, cfg.vocab_size, (1, PROMPT_HI), device=dev)
        pcache = init_cache(cfg, 1, PROMPT_HI, dev)
        prefill_1024_ms = graph_ms(
            lambda: transformer.forward_with_cache(
                cfg, params, ptoks, pcache.replace(max_length=0),
                fresh_cache=True), [()], 1)
    del pcache
    prefill_paths = moe_prefill_paths(cfg, params, dev, PROMPT_HI)
    reset_peak()

    # PagedBatchingEngine on serve's 48 requests, both pipelines, one
    # prefill a step.
    reg = Registry()
    engine = PagedBatchingEngine(
        cfg, params, n_slots=SLOTS, max_len=MAX_LEN, block_size=BLOCK,
        cache_backend="paged", decode_ticks=1, temperature=0.0, device=dev,
        registry=reg, **PIPELINED)
    reqs = serve_requests(seed + 1, cfg.vocab_size, REQUESTS,
                          (PROMPT_LO, PROMPT_HI), (NEW_LO, NEW_HI))
    engine.run(warm_requests(seed + 2, cfg.vocab_size))
    torch.cuda.synchronize()
    reset_peak()
    before = dict(engine.stats)
    totals0 = step_totals(reg)
    reset_counts(table)
    t0 = time.perf_counter()
    results = engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    serve_counts = read_counts(table)
    peak = torch.cuda.max_memory_allocated()
    breakdown = step_breakdown(totals0, step_totals(reg), wall)
    delta = {k: engine.stats[k] - before[k] for k in
             ("prefills", "decode_windows", "engine_steps")}
    expect = expected_launches(table, L, delta, 1, "paged_decode_attention")
    tokens_ok = (set(results) == {r[0] for r in reqs} and all(
        len(results[rid]) == m
        and all(0 <= t < cfg.vocab_size for t in results[rid])
        for rid, _, m in reqs))
    ttft, tpot = [], []
    for rid, _, m in reqs:
        _, admitted, first, done = engine.finished_timings[rid]
        ttft.append(first - admitted)
        tpot.append((done - first) / max(m - 1, 1))
    generated = sum(len(v) for v in results.values())
    # Decode-only steps: 16 slots decoding, no admission.
    full = serve_requests(seed + 3, cfg.vocab_size, SLOTS,
                          (PROMPT_HI // 2, PROMPT_HI // 2),
                          (NEW_HI // 2, NEW_HI // 2))
    fill_decoding(engine, full)
    walls = decode_step_walls(engine, steps=10)
    prof = profile_call(engine.step)
    with torch.inference_mode():
        cur = engine._cur[:, None]
        step_ms = graph_ms(lambda: transformer.forward_with_cache(
            cfg, params, cur, engine._cache), [()], 1)
        by_kind = moe_step_profile(cfg, params, cur, engine._cache)
    check_moe_decode_logits("moe", cfg, params, engine)
    graphs = {"decode": engine.stats["decode_graphs"],
              "prefill": prefill_graphs(engine)}
    engine.abort_all()
    clean = pristine(engine)
    engine.close()
    emit("moe", step="serve", model="gpt-oss-20b", slots=SLOTS,
         max_len=MAX_LEN, block_size=BLOCK, **PIPELINED,
         requests=len(reqs), generated_tokens=generated, wall_s=wall,
         tokens_per_s=generated / wall,
         ttft_ms_p50=pct(ttft, 50) * 1e3, ttft_ms_p99=pct(ttft, 99) * 1e3,
         tpot_ms_p50=pct(tpot, 50) * 1e3, tpot_ms_p99=pct(tpot, 99) * 1e3,
         wall_ms_per_tick=walls, wall_ms_per_tick_p50=float(np.median(walls)),
         decode_step_device_ms=step_ms,
         device_busy_share=step_ms / float(np.median(walls)),
         engine_step_device_ms_by_kind=prof["device_ms_by_kind"],
         engine_step_trace_lost=prof["trace_lost"],
         decode_step_by_kind=by_kind, prefill_1024_device_ms=prefill_1024_ms,
         moe_path="sorted segments (torch._grouped_mm) for every "
         "dropless bf16 call; capacity buckets where tokens may drop",
         prefill_moe_layer_paths=prefill_paths,
         step_breakdown=breakdown, engine_steps=delta["engine_steps"],
         prefills=delta["prefills"], decode_windows=delta["decode_windows"],
         launches=serve_counts, expected=expect, graphs_captured=graphs,
         tokens_ok=tokens_ok, allocator_pristine=clean,
         max_memory_allocated=peak, card=card)
    if serve_counts != expect or not tokens_ok or not clean \
            or graphs["prefill"] < 1 or graphs["decode"] != 1:
        raise SystemExit("moe serve: wrong launch counts, bad tokens, a "
                         "leaked block or a program not run as a graph")
    del engine, params
    reset_peak()
    return {k: gen_counts[k] + serve_counts[k] for k in gen_counts}


def phase_moe_parity(seed, dev):
    """GPT-OSS-20B's shape cut to 2 layers, fp32: greedy tokens of Engine,
    BatchingEngine and PagedBatchingEngine, each through the kernels and
    with attn_impl="ref", must be identical; the cached forward's logits
    (a fresh prefill, then decode steps) must equal the full forward's
    at the same positions within 1e-3 of their scale."""
    from shellac_tpu_torch import Engine
    from shellac_tpu_torch.inference.batching import (
        BatchingEngine,
        PagedBatchingEngine,
    )
    from shellac_tpu_torch.inference.cache import init_cache
    from shellac_tpu_torch.models import transformer

    cfg = gptoss_20b().replace(n_layers=2, dtype="float32")
    params = transformer.init_params(cfg, seed=seed, device=dev)
    reqs = serve_requests(seed + 4, cfg.vocab_size, 14, (16, 300), (4, 24))
    pad = max(t.size for _, t, _ in reqs)
    batch = np.zeros((len(reqs), pad), np.int64)
    for i, (_, t, _) in enumerate(reqs):
        batch[i, :t.size] = t
    btoks = torch.from_numpy(batch).to(dev)
    blens = torch.tensor([t.size for _, t, _ in reqs], dtype=torch.int32,
                         device=dev)
    top = max(m for _, _, m in reqs)
    out = {}
    for impl in ("auto", "ref"):
        res = Engine(cfg, params, max_len=512, temperature=0.0,
                     attn_impl=impl, device=dev).generate(
            btoks, blens, max_new_tokens=top)
        out[f"engine_{impl}"] = {rid: res.tokens[i, :m].tolist()
                                 for i, (rid, _, m) in enumerate(reqs)}
        for name, cls in (("dense", BatchingEngine),
                          ("paged", PagedBatchingEngine)):
            eng = cls(cfg, params, n_slots=6, max_len=512, attn_impl=impl,
                      device=dev)
            out[f"{name}_{impl}"] = {k: list(v)
                                     for k, v in eng.run(reqs).items()}
            eng.close()
            del eng
        torch.cuda.empty_cache()
    ref = out["paged_ref"]
    identical = {name: o == ref for name, o in out.items()}

    # The cached forward against the full forward: a 100-token prefill
    # of 2 prompts, then 8 greedy decode steps.
    rng = np.random.default_rng(seed + 5)
    ptoks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 100))).to(dev)
    with torch.inference_mode():
        cache = init_cache(cfg, 2, 512, dev)
        lg, cache = transformer.forward_with_cache(cfg, params, ptoks, cache,
                                                   fresh_cache=True)
        cached, seq = [lg], ptoks
        for _ in range(8):
            nxt = cached[-1][:, -1].argmax(-1)[:, None]
            seq = torch.cat([seq, nxt], dim=1)
            lg, cache = transformer.forward_with_cache(cfg, params, nxt,
                                                       cache)
            cached.append(lg)
        whole = transformer.forward(cfg, params, seq[:, :-1], device=dev)
        cached = torch.cat(cached, dim=1)[:, :whole.shape[1]]
    scale = whole.abs().max().item()
    err = (cached - whole).abs().max().item()
    logits_ok = bool(torch.isfinite(cached).all().item()) \
        and err <= 1e-3 * scale
    emit("moe-parity", model="gpt-oss-20b", layers=2, dtype="float32",
         requests=len(reqs), slots=6,
         tokens=sum(len(v) for v in ref.values()), identical=identical,
         cached_vs_full_forward={"positions": int(whole.shape[1]),
                                 "max_abs_err": err, "ref_max_abs": scale,
                                 "tol": "max_abs_err <= 1e-3 * max|ref|",
                                 "ok": logits_ok})
    del params, cache
    torch.cuda.empty_cache()
    if not all(identical.values()) or not logits_ok:
        raise SystemExit("moe-parity: greedy tokens differ across engines "
                         "or paths, or cached logits differ from the full "
                         "forward's")


def phase_graph_parity_moe(seed, dev, table):
    """graph-parity's window, prefill and continuation passes on
    GPT-OSS-20B's shape cut to 2 layers, bf16, over the paged and dense
    caches: MoE layers inside every window graph, prefill graph and
    continuation graph, bit-equal to the eager programs, launches
    exact."""
    from shellac_tpu_torch.models import transformer

    cfg = gptoss_20b().replace(n_layers=2)
    params = transformer.init_params(cfg, seed=seed, device=dev)
    reqs = serve_requests(seed + 4, cfg.vocab_size, 14, (16, 300), (4, 24))
    failed = []
    for backend in ("paged", "dense"):
        failed += window_prefill_parity(cfg, params, dev, table, backend,
                                        reqs, "graph-parity-moe")
        failed += continuation_parity(cfg, params, dev, table, backend,
                                      seed, "graph-parity-moe")
    del params
    torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"graph-parity-moe: the MoE model's CUDA graphs "
                         f"differ from the eager programs: {failed}")


def window_pairs(s, window):
    """(query, key) pairs of one causal row of s queries, each attending
    its last `window` positions (all of them without a window)."""
    w = s if window is None else window
    return sum(min(i + 1, w) for i in range(s))


def sink_mask(allowed, sinks, dtype):
    """An additive mask that makes scaled_dot_product_attention compute
    sink attention: k and v carry one zero key at the end, whose logit is
    each head's sink. allowed (..., Sq, Lk) bool for the real keys;
    returns (..., H, Sq, Lk + 1), -inf where a key is masked and each
    head's sink on the extra key."""
    lead, (sq, lk) = allowed.shape[:-2], allowed.shape[-2:]
    m = torch.empty(lead + (sinks.shape[0], sq, lk + 1), dtype=dtype,
                    device=allowed.device)
    m[..., :-1] = torch.where(allowed, 0.0, float("-inf")).to(
        dtype).unsqueeze(-3)
    m[..., -1] = sinks.to(dtype)[:, None]
    return m


def phase_kernels_moe(gen, dev, shapes, card):
    """Kernels 1, 2, 5 and 7 at GPT-OSS-20B's shapes (64 q heads over 8 kv
    heads of 64, sinks, the 128-token window and full attention; RMSNorm
    at width 2880), each against its plain version in bf16 and fp32, then
    timed in bf16 (CUDA-graph replay) beside its plain version, its bound
    and a library call: F.rms_norm for RMSNorm; for attention, whose sinks
    no one library call computes on these inputs (library_ms null),
    scaled_dot_product_attention with the sink as an extra zero key whose
    logit an additive mask carries (the appended key and mask built
    outside the timed call)."""
    from shellac_tpu_torch.inference.cache import paged_gather_layer
    from shellac_tpu_torch.ops.decode_attention import (
        _decode_ref,
        _paged_decode_ref,
        decode_attention_cuda,
        paged_decode_attention_cuda,
    )
    from shellac_tpu_torch.ops.flash_attention import (
        flash_attention_cuda,
        flash_attention_ref,
    )
    from shellac_tpu_torch.ops.norms import rms_norm_cuda, rms_norm_ref

    h, hkv, d, win = (GPTOSS_HEADS, GPTOSS_KV_HEADS, GPTOSS_HEAD_DIM,
                      GPTOSS_WINDOW)
    bf = torch.bfloat16
    failed, rows_out = [], []
    sinks = randn(gen, (h,), torch.float32, dev)
    gidx = shapes["decode"]["index"]
    sidx = shapes["paged"]["index"]
    rms_cases = {"generate_prefill_4096x2880": (PROMPTS * PAD, 2880),
                 "generate_decode_8x2880": (PROMPTS, 2880),
                 "serve_decode_16x2880": (SLOTS, 2880)}
    flash_cases = {f"{shape}_{kind}": (dict(b=b, s=s), w)
                   for shape, b, s in (("generate_8x512", PROMPTS, PAD),
                                       ("serve_b1_s1024", 1, PROMPT_HI))
                   for kind, w in (("window", win), ("full", None))}
    attn_kinds = {"window": win, "full": None}

    def check(kernel, case, dtype, out, ref):
        torch.cuda.synchronize()
        r = compare(out, ref, dtype)
        emit("kernels-moe", kernel=kernel, case=case, dtype=str(dtype), **r)
        if not r["ok"]:
            failed.append((kernel, case, str(dtype)))

    for dtype in (bf, torch.float32):
        for case, (rows, dm) in rms_cases.items():
            x, sc = rms_inputs(gen, rows, dm, dtype, dev)
            check("rms_norm", case, dtype, rms_norm_cuda(x, sc, 1e-5),
                  rms_norm_ref(x, sc, 1e-5))
        for case, (fs, w) in flash_cases.items():
            q, k, v = flash_inputs(gen, dtype, dev, hkv=hkv, h=h, d=d, **fs)
            kw = dict(causal=True, window=w, sinks=sinks)
            check("flash_attention_fwd", case, dtype,
                  flash_attention_cuda(q, k, v, **kw),
                  flash_attention_ref(q, k, v, **kw))
        for kind, w in attn_kinds.items():
            q, ck, cv, idx = decode_inputs(gen, dtype, dev, b=PROMPTS, s=1,
                                           h=h, hkv=hkv, L=MAX_LEN, d=d,
                                           index=gidx)
            check("decode_attention_dense", f"generate_b8_{kind}", dtype,
                  decode_attention_cuda(q, ck, cv, idx, window=w,
                                        sinks=sinks),
                  _decode_ref(q, ck, cv, idx, w, d ** -0.5, sinks=sinks))
            q, k, v, tab, idx, pk, pv = paged_inputs(
                gen, dtype, dev, s=1, h=h, hkv=hkv, d=d, bs=BLOCK,
                max_blocks=MAX_LEN // BLOCK, index=sidx, window=w)
            check("paged_decode_attention", f"serve_16_{kind}", dtype,
                  paged_decode_attention_cuda(q, pk, pv, tab, idx, window=w,
                                              sinks=sinks),
                  _paged_decode_ref(q, k, v, tab, idx, w, d ** -0.5,
                                    sinks=sinks))
            del q, k, v, pk, pv
    if failed:
        raise SystemExit(f"kernels-moe: kernels disagree with their plain "
                         f"versions at GPT-OSS's shapes: {failed}")

    # Timings, bf16.
    def row(kernel, case, k_ms, p_ms, nbytes, flops, shape, lib=None,
            sink_key=None):
        bms, by = bound(nbytes, flops, bf)
        r = {"kernel": kernel, "case": case, "ms": k_ms, "plain_ms": p_ms,
             "bound_ms": bms, "bound_by": by,
             "library_ms": lib, "shape": shape}
        if sink_key is not None:
            r["library_sink_key_ms"] = sink_key
        emit("kernels-moe", step="timings", dtype="bf16", bytes=nbytes,
             flops=flops, roofline_share=bms / k_ms, card=card, **r)
        rows_out.append(r)

    for case, (rows, dm) in rms_cases.items():
        def make():
            x, sc = rms_inputs(gen, rows, dm, bf, dev)
            return x, sc, (1.0 + sc).to(bf)

        sets = copies(make)
        row("rms_norm", case,
            graph_ms(lambda x, s, w: rms_norm_cuda(x, s, 1e-5), sets, 200),
            graph_ms(lambda x, s, w: rms_norm_ref(x, s, 1e-5), sets, 50),
            2 * rows * dm * 2 + dm * 4, 4 * rows * dm, [rows, dm],
            lib=graph_ms(lambda x, s, w: F.rms_norm(x, (dm,), w, 1e-5),
                         sets, 200))
        del sets
    for case, (fs, w) in flash_cases.items():
        b, s = fs["b"], fs["s"]
        sets = copies(lambda: flash_inputs(gen, bf, dev, hkv=hkv, h=h, d=d,
                                           **fs))
        pos = torch.arange(s, device=dev)
        allowed = pos[None, :] <= pos[:, None]
        if w is not None:
            allowed &= pos[None, :] > pos[:, None] - w
        mask = sink_mask(allowed, sinks, bf)
        zero = torch.zeros((b, hkv, 1, d), dtype=bf, device=dev)
        lib_sets = [(q.transpose(1, 2),
                     torch.cat([k.transpose(1, 2), zero], 2),
                     torch.cat([v.transpose(1, 2), zero], 2))
                    for q, k, v in sets]
        kw = dict(causal=True, window=w, sinks=sinks)
        pairs = b * h * window_pairs(s, w)
        row("flash_attention_fwd", case,
            graph_ms(lambda q, k, v: flash_attention_cuda(q, k, v, **kw),
                     sets, 20),
            graph_ms(lambda q, k, v: flash_attention_ref(q, k, v, **kw),
                     sets[:2], 4),
            (2 * b * s * h * d + 2 * b * s * hkv * d) * 2 + h * 4,
            4 * d * pairs, [b, s, h, hkv, d],
            sink_key=graph_ms(lambda q, k, v: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True), lib_sets, 20))
        del sets, lib_sets, mask
        torch.cuda.empty_cache()
    for kind, w in attn_kinds.items():
        live_rows = (gidx.long() + 1) if w is None \
            else (gidx.long() + 1).clamp_max(w)
        live = int(live_rows.sum().item())
        nbytes = 2 * PROMPTS * h * d * 2 + 2 * live * hkv * d * 2 \
            + PROMPTS * 4 + h * 4
        sets = copies(lambda: decode_inputs(gen, bf, dev, b=PROMPTS, s=1,
                                            h=h, hkv=hkv, L=MAX_LEN, d=d,
                                            index=gidx), nbytes=nbytes)
        pos = torch.arange(MAX_LEN, device=dev)[None, :]
        allowed = pos <= gidx[:, None].long()
        if w is not None:
            allowed &= pos > gidx[:, None].long() - w
        mask = sink_mask(allowed[:, None, :], sinks, bf)
        zero = torch.zeros((PROMPTS, hkv, 1, d), dtype=bf, device=dev)
        lib_sets = [(q.transpose(1, 2), torch.cat([ck, zero], 2),
                     torch.cat([cv, zero], 2)) for q, ck, cv, _ in sets]
        row("decode_attention_dense", f"generate_b8_{kind}",
            graph_ms(lambda q, ck, cv, i: decode_attention_cuda(
                q, ck, cv, i, window=w, sinks=sinks), sets, 200),
            graph_ms(lambda q, ck, cv, i: _decode_ref(
                q, ck, cv, i, w, d ** -0.5, sinks=sinks), sets, 50),
            nbytes, 4 * d * h * live, [PROMPTS, 1, h, hkv, MAX_LEN, d],
            sink_key=graph_ms(lambda q, k, v: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True), lib_sets, 200))
        del sets, lib_sets, mask
        live_rows = (sidx.long() + 1) if w is None \
            else (sidx.long() + 1).clamp_max(w)
        live = int(live_rows.sum().item())
        sets = copies(lambda: paged_inputs(
            gen, bf, dev, s=1, h=h, hkv=hkv, d=d, bs=BLOCK,
            max_blocks=MAX_LEN // BLOCK, index=sidx, window=w)[:5])
        pages = int(((live_rows + BLOCK - 1) // BLOCK).sum().item())
        pos = torch.arange(MAX_LEN, device=dev)[None, :]
        allowed = pos <= sidx[:, None].long()
        if w is not None:
            allowed &= pos > sidx[:, None].long() - w
        mask = sink_mask(allowed[:, None, :], sinks, bf)
        zero = torch.zeros((SLOTS, hkv, 1, d), dtype=bf, device=dev)

        def gather_sdpa(q, pk, pv, tab, i):
            kk, vv = paged_gather_layer(pk, pv, tab)
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), torch.cat([kk, zero], 2),
                torch.cat([vv, zero], 2), attn_mask=mask, enable_gqa=True)

        row("paged_decode_attention", f"serve_16_{kind}",
            graph_ms(lambda q, pk, pv, tab, i: paged_decode_attention_cuda(
                q, pk, pv, tab, i, window=w, sinks=sinks), sets, 200),
            graph_ms(lambda q, pk, pv, tab, i: _paged_decode_ref(
                q, pk, pv, tab, i, w, d ** -0.5, sinks=sinks), sets, 20),
            2 * SLOTS * h * d * 2 + 2 * live * hkv * d * 2 + pages * 4
            + SLOTS * 4 + h * 4, 4 * d * h * live,
            [SLOTS, 1, h, hkv, BLOCK, MAX_LEN // BLOCK, d],
            sink_key=graph_ms(gather_sdpa, sets, 50))
        del sets, mask
        torch.cuda.empty_cache()
    return rows_out


# --------------------------------------------------------------------------
# mla: DeepSeek's latent attention (shellac-mla-2b, DeepSeek-V2-Lite)
# --------------------------------------------------------------------------

MLA_HEADS, MLA_LATENT, MLA_QK = 16, 576, 192
# DeepSeek-V2-Lite's published config.json (huggingface.co/deepseek-ai/
# DeepSeek-V2-Lite), the keys the port's mapping reads.
DEEPSEEK_V2_LITE_HF = {
    "model_type": "deepseek_v2", "vocab_size": 102400, "hidden_size": 2048,
    "intermediate_size": 10944, "moe_intermediate_size": 1408,
    "num_hidden_layers": 27, "num_attention_heads": 16,
    "num_key_value_heads": 16, "n_shared_experts": 2,
    "n_routed_experts": 64, "routed_scaling_factor": 1.0,
    "kv_lora_rank": 512, "q_lora_rank": None, "qk_rope_head_dim": 64,
    "v_head_dim": 128, "qk_nope_head_dim": 128, "topk_method": "greedy",
    "n_group": 1, "topk_group": 1, "num_experts_per_tok": 6,
    "moe_layer_freq": 1, "first_k_dense_replace": 1,
    "norm_topk_prob": False, "scoring_func": "softmax",
    "aux_loss_alpha": 0.001, "seq_aux": True,
    "max_position_embeddings": 163840, "rms_norm_eps": 1e-6,
    "rope_theta": 10000, "rope_scaling": {
        "beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707,
        "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096,
        "type": "yarn"},
    "tie_word_embeddings": False, "attention_bias": False,
    "hidden_act": "silu", "torch_dtype": "bfloat16",
}


def deepseek_v2_lite():
    """DeepSeek-V2-Lite: the published config's keys (DEEPSEEK_V2_LITE_HF:
    27 layers, hidden 2048, 16 heads of MLA over a 512 latent with a
    64-wide rope slice, the first layer dense (intermediate 10944), then
    64 routed experts of 1408, 6 a token, 2 shared, softmax gate without
    renormalizing, vocab 102400, yarn rope of factor 40 over 4096
    positions) through the port's mapping (`models/convert.py`
    `config_from_hf`). About 15.7 B parameters."""
    from shellac_tpu_torch.models.convert import HFConfig, config_from_hf

    return config_from_hf(HFConfig(dict(DEEPSEEK_V2_LITE_HF)))


def mla_norms(cfg):
    """RMSNorm launches an MLA layer makes: attn, kv_a and mlp norms, and
    q_a's with low-rank queries."""
    return 3 + (cfg.mla.q_lora_rank is not None) + 2 * cfg.post_norms


def latent_bytes(cfg, kv_quant):
    """Cache bytes a token costs over all layers: the latent row, and what
    a GQA cache of the same heads (k at the qk width, v at v_head_dim, one
    head each) would hold, in the same storage (int8 with its fp32
    scales)."""
    m, L = cfg.mla, cfg.n_layers
    item = 1 if kv_quant else 2
    scales = 8 if kv_quant else 0  # ks and vs, fp32, per kv head
    return {"latent": L * (m.cache_dim * item + scales),
            "gqa_same_heads": L * cfg.n_heads * (
                (m.qk_head_dim + m.v_head_dim) * item + scales)}


def mla_generate(cfg, params, model, seed, dev, table, card, kv_quant):
    """Engine.generate at generate's shape (8 prompts padded to 512, 64
    new tokens, greedy) over the dense latent cache: exact launches,
    tokens/s, the prefill wall, a decode step's device ms and its kernels
    by kind, the cache's bytes beside a GQA cache's. Returns (counts,
    tokens)."""
    from shellac_tpu_torch import Engine
    from shellac_tpu_torch.inference.graphs import StepGraph
    from shellac_tpu_torch.models import transformer

    L = cfg.n_layers
    toks, lens = prompts(seed, cfg.vocab_size, dev)
    engine = Engine(cfg, params, max_len=MAX_LEN, temperature=0.0,
                    kv_quant=kv_quant, device=dev)
    captured = StepGraph.captures
    for _ in range(2):
        engine.generate(toks, lens, max_new_tokens=4)
    torch.cuda.synchronize()
    warm_captures = StepGraph.captures - captured
    reset_peak()
    reset_counts(table)
    captured = StepGraph.captures
    t0 = time.perf_counter()
    res = engine.generate(toks, lens, max_new_tokens=NEW_TOKENS)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = read_counts(table)
    captured = StepGraph.captures - captured
    peak = torch.cuda.max_memory_allocated()
    decode = "decode_attention_dense" + ("_int8" if kv_quant else "")
    expect = only(table, rms_norm=(mla_norms(cfg) * L + 1) * NEW_TOKENS,
                  flash_attention_fwd=L, **{decode: L * (NEW_TOKENS - 1)})
    tokens_ok = (tuple(res.tokens.shape) == (PROMPTS, NEW_TOKENS)
                 and bool(((res.tokens >= 0)
                           & (res.tokens < cfg.vocab_size)).all().item())
                 and bool(torch.isfinite(res.logprobs).all().item()))
    t0 = time.perf_counter()
    one = engine.generate(toks, lens, max_new_tokens=1)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    tokens_ok = tokens_ok and bool(torch.equal(one.tokens[:, 0],
                                               res.tokens[:, 0]))
    with torch.inference_mode():
        _, cache, _ = engine._prefill_impl(toks, lens)
        tok = res.tokens[:, :1].long()

        def step():
            return transformer.forward_with_cache(cfg, params, tok, cache)

        step_ms = graph_ms(step, [()], 1)
        prof = profile_call(step)
    per_token = latent_bytes(cfg, kv_quant)
    emit("mla", step="generate", model=model, cache="dense-int8"
         if kv_quant else "dense", prompts=PROMPTS, pad=PAD,
         new_tokens=NEW_TOKENS, launches=counts, expected=expect,
         tokens_ok=tokens_ok, total_s=total_s,
         tokens_per_s=PROMPTS * NEW_TOKENS / total_s,
         prefill_wall_ms=prefill_ms,
         decode_ms_per_token=(total_s * 1e3 - prefill_ms) / (NEW_TOKENS - 1),
         decode_step_device_ms=step_ms,
         decode_step_by_kind=prof["device_ms_by_kind"],
         decode_step_trace_lost=prof["trace_lost"],
         cache_bytes=pool_bytes(cache),
         cache_bytes_per_token=per_token,
         gqa_over_latent=per_token["gqa_same_heads"] / per_token["latent"],
         graphs_captured={"warm_up": warm_captures, "timed": captured},
         max_memory_allocated=peak, card=card)
    if counts != expect or not tokens_ok or captured != 0:
        raise SystemExit(f"mla generate ({model}, {kv_quant}): wrong launch "
                         "counts, bad tokens or a capture in the timed call")
    out = res.tokens
    del engine, cache, res, one
    reset_peak()
    return counts, out


def mla_serve(cfg, params, model, seed, dev, table, card, backend,
              requests=REQUESTS):
    """PagedBatchingEngine on serve's requests (16 slots, prompts 64-1024)
    over a latent pool, the reference serve's scheduling: tokens/s, TTFT
    and TPOT p50/p99, a 16-slot decode step's device ms by kind, the
    pool's bytes beside a GQA pool's, graphs, exact launches, the pool
    pristine after the drain. Returns the counts."""
    from shellac_tpu_torch.inference.batching import PagedBatchingEngine
    from shellac_tpu_torch.models import transformer
    from shellac_tpu_torch.obs import Registry

    L = cfg.n_layers
    reg = Registry()
    engine = PagedBatchingEngine(
        cfg, params, n_slots=SLOTS, max_len=MAX_LEN,
        block_size=BLOCK if backend == "paged" else BLOCK_INT8,
        cache_backend=backend, decode_ticks=1, temperature=0.0, device=dev,
        registry=reg, **PIPELINED)
    reqs = serve_requests(seed + 1, cfg.vocab_size, requests,
                          (PROMPT_LO, PROMPT_HI), (NEW_LO, NEW_HI))
    engine.run(warm_requests(seed + 2, cfg.vocab_size))
    torch.cuda.synchronize()
    reset_peak()
    before = dict(engine.stats)
    totals0 = step_totals(reg)
    reset_counts(table)
    t0 = time.perf_counter()
    results = engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(table)
    peak = torch.cuda.max_memory_allocated()
    breakdown = step_breakdown(totals0, step_totals(reg), wall)
    delta = {k: engine.stats[k] - before[k] for k in
             ("prefills", "decode_windows", "engine_steps")}
    expect = expected_launches(table, L, delta, 1, DECODE_KERNEL[backend],
                               norms=mla_norms(cfg))
    tokens_ok = (set(results) == {r[0] for r in reqs} and all(
        len(results[rid]) == m
        and all(0 <= t < cfg.vocab_size for t in results[rid])
        for rid, _, m in reqs))
    ttft, tpot = [], []
    for rid, _, m in reqs:
        _, admitted, first, done = engine.finished_timings[rid]
        ttft.append(first - admitted)
        tpot.append((done - first) / max(m - 1, 1))
    generated = sum(len(v) for v in results.values())
    full = serve_requests(seed + 3, cfg.vocab_size, SLOTS,
                          (PROMPT_HI // 2, PROMPT_HI // 2),
                          (NEW_HI // 2, NEW_HI // 2))
    fill_decoding(engine, full)
    walls = decode_step_walls(engine, steps=10)
    prof = profile_call(engine.step)
    with torch.inference_mode():
        cur = engine._cur[:, None]

        def step():
            return transformer.forward_with_cache(cfg, params, cur,
                                                  engine._cache)

        step_ms = graph_ms(step, [()], 1)
        step_prof = profile_call(step)
    if cfg.moe is not None:
        check_moe_decode_logits("mla", cfg, params, engine)
    else:
        check_decode_logits("mla", cfg, params, engine)
    graphs = {"decode": engine.stats["decode_graphs"],
              "prefill": prefill_graphs(engine)}
    engine.abort_all()
    clean = pristine(engine)
    per_token = latent_bytes(cfg, backend.endswith("int8"))
    pool = pool_bytes(engine._cache)
    engine.close()
    emit("mla", step="serve", model=model, cache=backend, slots=SLOTS,
         max_len=MAX_LEN, **PIPELINED, requests=len(reqs),
         generated_tokens=generated, wall_s=wall,
         tokens_per_s=generated / wall,
         ttft_ms_p50=pct(ttft, 50) * 1e3, ttft_ms_p99=pct(ttft, 99) * 1e3,
         tpot_ms_p50=pct(tpot, 50) * 1e3, tpot_ms_p99=pct(tpot, 99) * 1e3,
         wall_ms_per_tick_p50=float(np.median(walls)),
         decode_step_device_ms=step_ms,
         device_busy_share=step_ms / float(np.median(walls)),
         engine_step_device_ms_by_kind=prof["device_ms_by_kind"],
         engine_step_trace_lost=prof["trace_lost"],
         decode_step_by_kind=step_prof["device_ms_by_kind"],
         decode_step_trace_lost=step_prof["trace_lost"],
         step_breakdown=breakdown,
         pool_bytes=pool, pool_bytes_gqa_same_heads=int(
             pool * per_token["gqa_same_heads"] / per_token["latent"]),
         cache_bytes_per_token=per_token, prefills=delta["prefills"],
         decode_windows=delta["decode_windows"], launches=counts,
         expected=expect, graphs_captured=graphs, tokens_ok=tokens_ok,
         allocator_pristine=clean, max_memory_allocated=peak, card=card)
    if counts != expect or not tokens_ok or not clean \
            or graphs["prefill"] < 1 or graphs["decode"] != 1:
        raise SystemExit(f"mla serve ({model}, {backend}): wrong launch "
                         "counts, bad tokens, a leaked block or a program "
                         "not run as a graph")
    del engine
    reset_peak()
    return counts


def mla_prefix_and_beam(cfg, params, model, seed, dev, table, card):
    """The paged latent pool with the prefix cache: a round on one shared
    1024-token system prompt (hits reuse its latent blocks: their suffixes
    skip kernel 2), then a K = 4 beam search over the pool, the best beam
    beside the single-request Engine's. Returns the counts of both."""
    from shellac_tpu_torch import Engine
    from shellac_tpu_torch.inference.batching import PagedBatchingEngine

    L = cfg.n_layers
    engine = PagedBatchingEngine(
        cfg, params, n_slots=SLOTS, max_len=MAX_LEN, block_size=BLOCK,
        cache_backend="paged", decode_ticks=1, prefix_cache=True,
        temperature=0.0, device=dev, **PIPELINED)
    engine.run(prefix_warm_requests(seed + 6, cfg.vocab_size))
    reqs = prefix_requests(seed + 7, cfg.vocab_size, 24)
    results, counts, expect, m = prefix_run(
        engine, table, reqs, L, "paged_decode_attention",
        norms=mla_norms(cfg))
    tokens_ok = all(len(results[rid]) == n for rid, _, n in reqs)
    emit("mla", step="prefix_serve", model=model, **m, tokens_ok=tokens_ok,
         card=card)
    if counts != expect or not tokens_ok or m["hit_requests"] < 1:
        raise SystemExit("mla prefix-serve: wrong launch counts, bad tokens "
                         "or no hit")
    prompt = reqs[0][1][:300]
    k, steps = 4, 32
    engine.beam_search(prompt, num_beams=k, max_new_tokens=steps)
    torch.cuda.synchronize()
    reset_counts(table)
    t0 = time.perf_counter()
    seqs, scores = engine.beam_search(prompt, num_beams=k,
                                      max_new_tokens=steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    beam_counts = read_counts(table)
    single = Engine(cfg, params, max_len=MAX_LEN, device=dev)
    want, _ = single.beam_search(prompt, num_beams=k, max_new_tokens=steps)
    ok = (len(seqs) == k and all(len(q) == steps for q in seqs)
          and all(np.isfinite(scores))
          and list(scores) == sorted(scores, reverse=True)
          and beam_counts["paged_decode_attention"] > 0)
    emit("mla", step="beam", model=model, num_beams=k, steps=steps,
         prompt_tokens=int(prompt.size), wall_ms=wall * 1e3,
         ms_per_step=wall * 1e3 / steps, scores=list(scores),
         best_equals_single_engine=seqs[0] == want[0], launches=beam_counts,
         ok=ok, card=card)
    engine.abort_all()
    # The prefix registry keeps its blocks; no slot may keep any.
    clean = all(not b for b in engine.cache_backend._slot_blocks)
    engine.close()
    del engine, single
    reset_peak()
    if not ok or not clean:
        raise SystemExit("mla beam: bad beams or a leaked block")
    return {n: counts[n] + beam_counts[n] for n in counts}


def phase_mla(seed, dev, table, card):
    """shellac-mla-2b at full width and depth (20 layers, random weights
    from --seed): generate over the dense and dense-int8 latent caches,
    serve over the paged and paged-int8 latent pools, a prefix-hit round
    and a K = 4 beam search over the paged pool; then DeepSeek-V2-Lite's
    shape (its published keys, random weights): generate and serve over
    the bf16 caches. The decode runs kernels 5-7 at D 576 and the
    prefill kernel 2 at 192, all inside the engines' CUDA graphs.
    Returns the launch counts of every run together."""
    from shellac_tpu_torch.models import transformer
    from shellac_tpu_torch.models.registry import get_model_config

    total = {k["name"]: 0 for k in table}

    def add(counts):
        for n in total:
            total[n] += counts[n]

    reset_peak()
    for model, make in (("shellac-mla-2b",
                         lambda: get_model_config("shellac-mla-2b")),
                        ("deepseek-v2-lite", deepseek_v2_lite)):
        cfg = make()
        t0 = time.perf_counter()
        params = transformer.init_params(cfg, seed=seed, device=dev)
        torch.cuda.synchronize()
        emit("mla", step="init_params", model=model,
             params=transformer.num_params(params),
             weight_bytes=torch.cuda.memory_allocated(),
             seconds=time.perf_counter() - t0, layers=cfg.n_layers,
             d_model=cfg.d_model, heads=cfg.n_heads,
             latent=cfg.mla.cache_dim, qk_head_dim=cfg.mla.qk_head_dim,
             moe=None if cfg.moe is None else {
                 "experts": cfg.moe.num_experts,
                 "per_token": cfg.moe.num_experts_per_token,
                 "shared": cfg.moe.num_shared_experts,
                 "first_k_dense": cfg.first_k_dense}, card=card)
        if model == "shellac-mla-2b":
            counts, bf16_tokens = mla_generate(cfg, params, model, seed,
                                               dev, table, card, None)
            add(counts)
            counts, int8_tokens = mla_generate(cfg, params, model, seed,
                                               dev, table, card, "int8")
            add(counts)
            # The first token comes from the exact prefill in both.
            if not torch.equal(bf16_tokens[:, 0], int8_tokens[:, 0]):
                raise SystemExit("mla generate-int8: first tokens differ "
                                 "from bf16's")
            emit("mla", step="generate_int8_agreement", model=model,
                 greedy_tokens_equal=int((bf16_tokens == int8_tokens)
                                         .sum().item()),
                 of=int(bf16_tokens.numel()))
            for backend in ("paged", "paged-int8"):
                add(mla_serve(cfg, params, model, seed, dev, table, card,
                              backend))
            add(mla_prefix_and_beam(cfg, params, model, seed, dev, table,
                                    card))
        else:
            counts, _ = mla_generate(cfg, params, model, seed, dev, table,
                                     card, None)
            add(counts)
            add(mla_serve(cfg, params, model, seed, dev, table, card,
                          "paged", requests=REQUESTS // 2))
        del params
        reset_peak()
    emit("mla", step="main_path", launches=total, card=card)
    return total


def mla_inputs(gen, dtype, dev, b, L, index, quant=False, heads=None):
    """The absorbed decode's inputs: q (b, 1, heads (16), 576) and a dense
    latent cache (b, 1, L, 576) that serves as k and v (int8 with one
    scale a row, shared, when `quant`)."""
    q = randn(gen, (b, 1, heads or MLA_HEADS, MLA_LATENT), dtype, dev)
    if quant:
        c, sc = quant_rows(gen, (b, 1, L, MLA_LATENT), dev)
        return q, c, sc, index
    return q, randn(gen, (b, 1, L, MLA_LATENT), dtype, dev), index


def mla_paged_inputs(gen, dtype, dev, bs, index, quant=False):
    """A latent pool (n_blocks, 1, bs, 576) serving as k and v, shuffled
    pages (`paged_tables`), and its poisoned copy (NaN rows, or NaN
    scales in int8, wherever no slot attends). Returns (q, pool, scales
    or None, tables, index, poisoned pool, poisoned scales or None)."""
    tables, index, live, n_blocks = paged_tables(
        gen, dev, 1, bs, MAX_LEN // bs, index)
    q = randn(gen, (len(index), 1, MLA_HEADS, MLA_LATENT), dtype, dev)
    dead = ~live[:, None, :]
    if quant:
        pool, sc = quant_rows(gen, (n_blocks, 1, bs, MLA_LATENT), dev)
        psc = sc.masked_fill(dead, float("nan"))
        return q, pool, sc, tables, index, pool, psc
    pool = randn(gen, (n_blocks, 1, bs, MLA_LATENT), dtype, dev)
    return (q, pool, None, tables, index,
            pool.masked_fill(dead[..., None], float("nan")), None)


def phase_kernels_mla(gen, dev, shapes, card):
    """Kernels 1, 2 and 5-7 at MLA's widths against their plain versions
    in bf16 and fp32: RMSNorm at kv_a_norm's 512; the flash forward at
    192 (the expanded prefill: 16 heads of q, k and v, v zero-padded from
    128) at generate's prefill and serve's largest admission; the
    absorbed decode at 576 (16 q rows against one latent row a token,
    the same array as k and v) over generate's dense cache (bf16, also at
    128 heads, and int8) and serve's pools (bf16 blocks of 16, int8 of 64), the pools
    poisoned with NaN wherever no slot attends. Then each timed in bf16
    by CUDA-graph replay beside its plain version, its bound and a
    library call: F.rms_norm; scaled_dot_product_attention at 192 and,
    at 576, masked scaled_dot_product_attention over the latent as k and
    v (for the int8 and paged kernels, which no one call computes, a
    dequantize, a gather or both before it). Returns (errs, rows): the
    bf16 max_abs_err and the timing of each kernel's main-path case."""
    from shellac_tpu_torch.inference.cache import paged_gather_scales
    from shellac_tpu_torch.ops.decode_attention import (
        _decode_ref,
        _dequantize,
        _paged_decode_ref,
        decode_attention_cuda,
        decode_attention_quant_cuda,
        paged_decode_attention_cuda,
        paged_decode_attention_quant_cuda,
    )
    from shellac_tpu_torch.ops.flash_attention import (
        flash_attention_cuda,
        flash_attention_ref,
    )
    from shellac_tpu_torch.ops.norms import rms_norm_cuda, rms_norm_ref

    bf = torch.bfloat16
    scale = MLA_QK ** -0.5
    gidx, sidx = shapes["decode"]["index"], shapes["paged"]["index"]
    failed, errs, rows_out = [], {}, {}
    rms_cases = {"serve_decode_16x512": (SLOTS, 512),
                 "prefill_4096x512": (PROMPTS * PAD, 512)}
    flash_cases = {"generate_8x512": (PROMPTS, PAD),
                   "serve_b1_s1024": (1, PROMPT_HI)}

    def flash192(dtype, b, s):
        q, k, v = flash_inputs(gen, dtype, dev, b, s, MLA_HEADS, MLA_HEADS,
                               MLA_QK)
        return q, k, F.pad(v[..., :128], (0, MLA_QK - 128))

    def check(kernel, case, dtype, out, ref):
        torch.cuda.synchronize()
        r = compare(out, ref, dtype)
        emit("kernels-mla", kernel=kernel, case=case, dtype=str(dtype), **r)
        if dtype == bf:
            errs.setdefault(kernel, r["max_abs_err"])
        if not r["ok"]:
            failed.append((kernel, case, str(dtype)))

    for dtype in (bf, torch.float32):
        for case, (rows, d) in rms_cases.items():
            x, sc = rms_inputs(gen, rows, d, dtype, dev)
            check("rms_norm_d512", case, dtype, rms_norm_cuda(x, sc, 1e-5),
                  rms_norm_ref(x, sc, 1e-5))
        for case, (b, s) in flash_cases.items():
            q, k, v = flash192(dtype, b, s)
            check("flash_attention_fwd_d192", case, dtype,
                  flash_attention_cuda(q, k, v),
                  flash_attention_ref(q, k, v))
        q, c, idx = mla_inputs(gen, dtype, dev, PROMPTS, MAX_LEN, gidx)
        check("decode_attention_dense_d576", "generate_b8", dtype,
              decode_attention_cuda(q, c, c, idx, scale=scale),
              _decode_ref(q, c, c, idx, None, scale))
        # DeepSeek-V2/V3's 128 heads: 8 CTAs of 16 rows a slot.
        q, c, idx = mla_inputs(gen, dtype, dev, PROMPTS, MAX_LEN, gidx,
                               heads=128)
        check("decode_attention_dense_d576", "generate_b8_128_heads", dtype,
              decode_attention_cuda(q, c, c, idx, scale=scale),
              _decode_ref(q, c, c, idx, None, scale))
        q, c, sc, idx = mla_inputs(gen, dtype, dev, PROMPTS, MAX_LEN, gidx,
                                   quant=True)
        check("decode_attention_dense_int8_d576", "generate_b8", dtype,
              decode_attention_quant_cuda(q, c, c, sc, sc, idx, scale=scale),
              _decode_ref(q, c, c, idx, None, scale, k_scale=sc,
                          v_scale=sc))
        q, pool, _, tab, idx, pp, _ = mla_paged_inputs(gen, dtype, dev,
                                                       BLOCK, sidx)
        check("paged_decode_attention_d576", "serve_16_bs16", dtype,
              paged_decode_attention_cuda(q, pp, pp, tab, idx, scale=scale),
              _paged_decode_ref(q, pool, pool, tab, idx, None, scale))
        q, pool, sc, tab, idx, _, psc = mla_paged_inputs(
            gen, dtype, dev, BLOCK_INT8, sidx, quant=True)
        check("paged_decode_attention_int8_d576", "serve_16_bs64", dtype,
              paged_decode_attention_quant_cuda(q, pool, pool, psc, psc, tab,
                                                idx, scale=scale),
              _paged_decode_ref(q, pool, pool, tab, idx, None, scale,
                                k_scale=sc, v_scale=sc))
        del q, pool, c
        torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"kernels-mla: kernels disagree with their plain "
                         f"versions at MLA's widths: {failed}")
    check_bodies_576(gen, dev, gidx, sidx)

    def row(kernel, case, k_ms, p_ms, nbytes, flops, shape, lib=None,
            calls=None):
        bms, by = bound(nbytes, flops, bf)
        r = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bms, "bound_by": by,
             "library_ms": lib, "shape": shape}
        if calls is not None:
            r["library_calls_ms"], r["library_calls_what"] = calls
        emit("kernels-mla", step="timings", kernel=kernel, case=case,
             dtype="bf16", bytes=nbytes, flops=flops,
             roofline_share=bms / k_ms, card=card, **r)
        rows_out.setdefault(kernel, r)

    for case, (rows, d) in rms_cases.items():
        def make():
            x, sc = rms_inputs(gen, rows, d, bf, dev)
            return x, sc, (1.0 + sc).to(bf)

        sets = copies(make)
        row("rms_norm_d512", case,
            graph_ms(lambda x, s, w: rms_norm_cuda(x, s, 1e-5), sets, 200),
            graph_ms(lambda x, s, w: rms_norm_ref(x, s, 1e-5), sets, 50),
            2 * rows * d * 2 + d * 4, 4 * rows * d, [rows, d],
            lib=graph_ms(lambda x, s, w: F.rms_norm(x, (d,), w, 1e-5),
                         sets, 200))
        del sets
    for case, (b, s) in flash_cases.items():
        sets = copies(lambda: flash192(bf, b, s))
        lib_sets = [tuple(t.transpose(1, 2) for t in qkv) for qkv in sets]
        pairs = b * MLA_HEADS * s * (s + 1) // 2
        row("flash_attention_fwd_d192", case,
            graph_ms(lambda q, k, v: flash_attention_cuda(q, k, v), sets,
                     20),
            graph_ms(lambda q, k, v: flash_attention_ref(q, k, v), sets[:2],
                     4),
            4 * b * s * MLA_HEADS * MLA_QK * 2, 4 * MLA_QK * pairs,
            [b, s, MLA_HEADS, MLA_HEADS, MLA_QK],
            lib=graph_ms(lambda q, k, v: F.scaled_dot_product_attention(
                q, k, v, is_causal=True), lib_sets, 20))
        del sets, lib_sets
        torch.cuda.empty_cache()

    def decode_bytes(b, live, item, scales, heads=MLA_HEADS):
        # q and out once each, the live latent rows once (k and v are one
        # array), their scales, the index.
        return (2 * b * heads * MLA_LATENT * 2
                + live * (MLA_LATENT * item + scales) + b * 4)

    live = int((gidx.long() + 1).sum().item())
    flops = 4 * MLA_LATENT * MLA_HEADS * live
    pos = torch.arange(MAX_LEN, device=dev)[None, :]
    gmask = (pos <= gidx[:, None].long())[:, None, None, :]
    for quant in (False, True):
        name = ("decode_attention_dense_int8_d576" if quant
                else "decode_attention_dense_d576")
        nbytes = decode_bytes(PROMPTS, live, 1 if quant else 2,
                              4 if quant else 0)
        sets = copies(lambda: mla_inputs(gen, bf, dev, PROMPTS, MAX_LEN,
                                         gidx, quant), nbytes=nbytes)
        if quant:
            k_ms = graph_ms(lambda q, c, sc, i: decode_attention_quant_cuda(
                q, c, c, sc, sc, i, scale=scale), sets, 200)
            p_ms = graph_ms(lambda q, c, sc, i: _decode_ref(
                q, c, c, i, None, scale, k_scale=sc, v_scale=sc), sets, 20)

            def deq_sdpa(q, c, sc, i):
                kv = _dequantize(c, sc, bf)
                return F.scaled_dot_product_attention(
                    q.transpose(1, 2), kv, kv, attn_mask=gmask,
                    scale=scale, enable_gqa=True)

            row(name, "generate_b8", k_ms, p_ms, nbytes, flops,
                [PROMPTS, 1, MLA_HEADS, 1, MAX_LEN, MLA_LATENT],
                calls=(graph_ms(deq_sdpa, sets, 20),
                       "dequantize + masked SDPA, two calls"))
        else:
            row(name, "generate_b8",
                graph_ms(lambda q, c, i: decode_attention_cuda(
                    q, c, c, i, scale=scale), sets, 200),
                graph_ms(lambda q, c, i: _decode_ref(q, c, c, i, None,
                                                     scale), sets, 20),
                nbytes, flops, [PROMPTS, 1, MLA_HEADS, 1, MAX_LEN,
                                MLA_LATENT],
                lib=graph_ms(lambda q, c, i: F.scaled_dot_product_attention(
                    q.transpose(1, 2), c, c, attn_mask=gmask, scale=scale,
                    enable_gqa=True), sets, 20))
        del sets
        torch.cuda.empty_cache()
    # DeepSeek-V2/V3's 128 heads over the same latent: 8 CTAs of 16 rows
    # a slot, each reading the latent's tiles.
    nbytes = decode_bytes(PROMPTS, live, 2, 0, heads=128)
    sets = copies(lambda: mla_inputs(gen, bf, dev, PROMPTS, MAX_LEN, gidx,
                                     heads=128), nbytes=nbytes)
    row("decode_attention_dense_d576", "generate_b8_128_heads",
        graph_ms(lambda q, c, i: decode_attention_cuda(
            q, c, c, i, scale=scale), sets, 200),
        graph_ms(lambda q, c, i: _decode_ref(q, c, c, i, None, scale), sets,
                 20),
        nbytes, flops * 128 // MLA_HEADS,
        [PROMPTS, 1, 128, 1, MAX_LEN, MLA_LATENT],
        lib=graph_ms(lambda q, c, i: F.scaled_dot_product_attention(
            q.transpose(1, 2), c, c, attn_mask=gmask, scale=scale,
            enable_gqa=True), sets, 20))
    del sets
    torch.cuda.empty_cache()

    def gather_latent(pool, tables):
        # Each slot's pages of the one latent pool, (B, 1, pages * bs, D).
        b, mb = tables.shape
        x = pool[tables.reshape(-1).long()]
        return x.reshape(b, mb * pool.shape[2], MLA_LATENT)[:, None]

    live = int((sidx.long() + 1).sum().item())
    flops = 4 * MLA_LATENT * MLA_HEADS * live
    smask = (pos <= sidx[:, None].long())[:, None, None, :]
    for quant in (False, True):
        bs = BLOCK_INT8 if quant else BLOCK
        name = ("paged_decode_attention_int8_d576" if quant
                else "paged_decode_attention_d576")
        pages = int(((sidx.long() + bs) // bs).sum().item())
        nbytes = decode_bytes(SLOTS, live, 1 if quant else 2,
                              4 if quant else 0) + pages * 4
        sets = copies(lambda: mla_paged_inputs(gen, bf, dev, bs, sidx,
                                               quant)[:5], nbytes=nbytes)
        if quant:
            k_ms = graph_ms(lambda q, p, sc, t, i:
                            paged_decode_attention_quant_cuda(
                                q, p, p, sc, sc, t, i, scale=scale),
                            sets, 200)
            p_ms = graph_ms(lambda q, p, sc, t, i: _paged_decode_ref(
                q, p, p, t, i, None, scale, k_scale=sc, v_scale=sc),
                sets, 10)

            def route(q, p, sc, t, i):
                kv = _dequantize(gather_latent(p, t),
                                 paged_gather_scales(sc, t), bf)
                return F.scaled_dot_product_attention(
                    q.transpose(1, 2), kv, kv, attn_mask=smask,
                    scale=scale, enable_gqa=True)
            what = "gather + dequantize + masked SDPA, three calls"
        else:
            k_ms = graph_ms(lambda q, p, sc, t, i:
                            paged_decode_attention_cuda(
                                q, p, p, t, i, scale=scale), sets, 200)
            p_ms = graph_ms(lambda q, p, sc, t, i: _paged_decode_ref(
                q, p, p, t, i, None, scale), sets, 10)

            def route(q, p, sc, t, i):
                kv = gather_latent(p, t)
                return F.scaled_dot_product_attention(
                    q.transpose(1, 2), kv, kv, attn_mask=smask,
                    scale=scale, enable_gqa=True)
            what = "gather + masked SDPA, two calls"
        row(name, f"serve_16_bs{bs}", k_ms, p_ms, nbytes, flops,
            [SLOTS, 1, MLA_HEADS, 1, bs, MAX_LEN // bs, MLA_LATENT],
            calls=(graph_ms(route, sets, 20), what))
        del sets
        torch.cuda.empty_cache()
    return errs, rows_out


def check_bodies_576(gen, dev, gidx, sidx):
    """A bf16 call of kernel 5, 6 or 7 at 576 launches the tensor-core body
    (`decode_wide_mma`) and nothing else; an fp32 call the CUDA-core
    parity body (`decode_wide_kernel`). By the profiler's kernel names (a
    trace that holds no kernel is taken again, twice at most)."""
    from shellac_tpu_torch.ops.decode_attention import (
        decode_attention_cuda,
        decode_attention_quant_cuda,
        paged_decode_attention_cuda,
        paged_decode_attention_quant_cuda,
    )

    scale = MLA_QK ** -0.5
    bodies, ok = {}, True
    for dtype, body in ((torch.bfloat16, "decode_wide_mma"),
                        (torch.float32, "decode_wide_kernel")):
        q, c, idx = mla_inputs(gen, dtype, dev, PROMPTS, MAX_LEN, gidx)
        _, c8, sc, _ = mla_inputs(gen, dtype, dev, PROMPTS, MAX_LEN, gidx,
                                  quant=True)
        qp, pool, _, tab, pidx, _, _ = mla_paged_inputs(gen, dtype, dev,
                                                        BLOCK, sidx)
        qp8, pool8, psc, tab8, _, _, _ = mla_paged_inputs(
            gen, dtype, dev, BLOCK_INT8, sidx, quant=True)
        calls = {
            "decode_attention_dense": lambda: decode_attention_cuda(
                q, c, c, idx, scale=scale),
            "decode_attention_dense_int8": lambda: decode_attention_quant_cuda(
                q, c8, c8, sc, sc, idx, scale=scale),
            "paged_decode_attention": lambda: paged_decode_attention_cuda(
                qp, pool, pool, tab, pidx, scale=scale),
            "paged_decode_attention_int8":
                lambda: paged_decode_attention_quant_cuda(
                    qp8, pool8, pool8, psc, psc, tab8, pidx, scale=scale),
        }
        for name, fn in calls.items():
            for _ in range(3):
                top = profile_call(fn, top=4)["top"]
                if top:
                    break
            got = [(t["kernel"], t["count"]) for t in top]
            bodies[f"{name}_{str(dtype)[6:]}"] = got
            ok = ok and len(got) == 1 and got[0][1] == 1 and body in got[0][0]
        del q, c, c8, sc, qp, pool, qp8, pool8, psc
        torch.cuda.empty_cache()
    emit("kernels-mla", step="bodies_d576", bodies=bodies, ok=ok)
    if not ok:
        raise SystemExit(f"kernels-mla: a call at 576 did not run its body "
                         f"alone (bf16: decode_wide_mma; fp32: "
                         f"decode_wide_kernel): {bodies}")


def phase_mla_parity(seed, dev):
    """shellac-mla-2b cut to 2 layers, fp32: greedy tokens of Engine,
    BatchingEngine and PagedBatchingEngine over the latent caches, each
    through the kernels (576 and 192) and with attn_impl="ref", must be
    identical; the cached forward's logits (the expanded prefill, then
    absorbed decode steps) must equal the full forward's at the same
    positions within 1e-3 of their scale."""
    from shellac_tpu_torch import Engine
    from shellac_tpu_torch.inference.batching import (
        BatchingEngine,
        PagedBatchingEngine,
    )
    from shellac_tpu_torch.inference.cache import init_cache
    from shellac_tpu_torch.models import transformer
    from shellac_tpu_torch.models.registry import get_model_config

    cfg = get_model_config("shellac-mla-2b").replace(n_layers=2,
                                                     dtype="float32")
    params = transformer.init_params(cfg, seed=seed, device=dev)
    reqs = serve_requests(seed + 4, cfg.vocab_size, 14, (16, 300), (4, 24))
    pad = max(t.size for _, t, _ in reqs)
    batch = np.zeros((len(reqs), pad), np.int64)
    for i, (_, t, _) in enumerate(reqs):
        batch[i, :t.size] = t
    btoks = torch.from_numpy(batch).to(dev)
    blens = torch.tensor([t.size for _, t, _ in reqs], dtype=torch.int32,
                         device=dev)
    top = max(m for _, _, m in reqs)
    out = {}
    for impl in ("auto", "ref"):
        res = Engine(cfg, params, max_len=512, temperature=0.0,
                     attn_impl=impl, device=dev).generate(
            btoks, blens, max_new_tokens=top)
        out[f"engine_{impl}"] = {rid: res.tokens[i, :m].tolist()
                                 for i, (rid, _, m) in enumerate(reqs)}
        for name, cls in (("dense", BatchingEngine),
                          ("paged", PagedBatchingEngine)):
            eng = cls(cfg, params, n_slots=6, max_len=512, attn_impl=impl,
                      device=dev)
            out[f"{name}_{impl}"] = {k: list(v)
                                     for k, v in eng.run(reqs).items()}
            eng.close()
            del eng
        torch.cuda.empty_cache()
    ref = out["paged_ref"]
    identical = {name: o == ref for name, o in out.items()}
    rng = np.random.default_rng(seed + 5)
    ptoks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 100))).to(dev)
    with torch.inference_mode():
        cache = init_cache(cfg, 2, 512, dev)
        lg, cache = transformer.forward_with_cache(cfg, params, ptoks, cache,
                                                   fresh_cache=True)
        cached, seq = [lg], ptoks
        for _ in range(8):
            nxt = cached[-1][:, -1].argmax(-1)[:, None]
            seq = torch.cat([seq, nxt], dim=1)
            lg, cache = transformer.forward_with_cache(cfg, params, nxt,
                                                       cache)
            cached.append(lg)
        whole = transformer.forward(cfg, params, seq[:, :-1], device=dev)
        cached = torch.cat(cached, dim=1)[:, :whole.shape[1]]
    scale = whole.abs().max().item()
    err = (cached - whole).abs().max().item()
    logits_ok = bool(torch.isfinite(cached).all().item()) \
        and err <= 1e-3 * scale
    emit("mla-parity", model="shellac-mla-2b", layers=2, dtype="float32",
         requests=len(reqs), slots=6,
         tokens=sum(len(v) for v in ref.values()), identical=identical,
         cached_vs_full_forward={"positions": int(whole.shape[1]),
                                 "max_abs_err": err, "ref_max_abs": scale,
                                 "tol": "max_abs_err <= 1e-3 * max|ref|",
                                 "ok": logits_ok})
    del params, cache
    torch.cuda.empty_cache()
    if not all(identical.values()) or not logits_ok:
        raise SystemExit("mla-parity: greedy tokens differ across engines "
                         "or paths, or cached logits differ from the full "
                         "forward's")


# The MLA instances' rows in the kernels line: (name, the wrapper whose
# mla-phase count is theirs, source, the TPU kernel).
MLA_ROWS = (
    ("flash_attention_fwd_d192", "flash_attention_fwd",
     "shellac_tpu_torch/csrc/flash_attention.cu",
     "shellac_tpu/ops/flash_attention.py:226"),
    ("decode_attention_dense_d576", "decode_attention_dense",
     "shellac_tpu_torch/csrc/decode_wide.cuh",
     "shellac_tpu/ops/decode_attention.py:315"),
    ("decode_attention_dense_int8_d576", "decode_attention_dense_int8",
     "shellac_tpu_torch/csrc/decode_wide.cuh",
     "shellac_tpu/ops/decode_attention.py:334"),
    ("paged_decode_attention_d576", "paged_decode_attention",
     "shellac_tpu_torch/csrc/decode_wide.cuh",
     "shellac_tpu/ops/decode_attention.py:562"),
    ("paged_decode_attention_int8_d576", "paged_decode_attention_int8",
     "shellac_tpu_torch/csrc/decode_wide.cuh",
     "shellac_tpu/ops/decode_attention.py:562 (quant)"),
)


# --------------------------------------------------------------------------
# timings
# --------------------------------------------------------------------------


# --------------------------------------------------------------------------
# real-weights: HF checkpoints in, the native directory, a real tokenizer
# with its chat template over HTTP, the Checkpointer
# --------------------------------------------------------------------------

# The HF tokenizer directory the phase serves with (a byte-level BPE of
# 4096 tokens with a chat template, made by
# scripts/make_tokenizer_fixture.py).
TOKENIZER_DIR = ("tests", "fixtures", "tokenizer")
REAL_TEXT = "Continuous batching keeps every slot of the card busy, "
REAL_NEW, REAL_CHATS, REAL_CHAT_TOKENS = 32, 8, 32
# Greedy tokens are compared where the source model's top-2 margin is at
# least twice the logit tolerance (5e-2 of the logits' scale).
LOGIT_TOL = 5e-2
# Norm scales the export makes real (the init's are zeros, which round
# trip exactly).
NORM_STD = 0.1
NORM_KEYS = ("attn_norm", "mlp_norm", "final_norm", "q_norm", "k_norm",
             "post_attn_norm", "post_mlp_norm")


def llama_hf_config(cfg):
    """A ModelConfig of the Llama family as the keys of an HF Llama
    config.json, as a Llama checkpoint carries them."""
    return {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.d_model,
            "intermediate_size": cfg.ff_dim,
            "num_hidden_layers": cfg.n_layers,
            "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.kv_heads,
            "head_dim": cfg.dim_per_head,
            "max_position_embeddings": cfg.max_seq_len,
            "rms_norm_eps": cfg.norm_eps, "rope_theta": cfg.rope_theta,
            "tie_word_embeddings": cfg.tie_embeddings,
            "attention_bias": False, "hidden_act": "silu",
            "torch_dtype": "bfloat16", "bos_token_id": 0, "eos_token_id": 1}


def write_hf(path, hf_config, cfg, params, shards=2):
    """`params` as an HF checkpoint directory: bf16 safetensors in
    `shards` files with their index (the tied lm_head left out, as
    save_pretrained leaves it) and config.json. Returns the bytes of the
    tensors written."""
    import os

    from shellac_tpu_torch.models.convert import to_state_dict
    from shellac_tpu_torch.utils.safetensors import save_sharded

    sd = to_state_dict(cfg, params, dtype=torch.bfloat16)
    if cfg.tie_embeddings:
        del sd["lm_head.weight"]
    save_sharded(sd, path, shards=shards)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_config, f, indent=2)
    return sum(t.numel() * t.element_size() for t in sd.values())


def params_round_trip(got, want):
    """Every leaf of `got` against `want`: matrices, embeddings, biases,
    sinks and the router bit-equal; norm scales equal to the rounding the
    conversion makes (the reference's too): s + 1 exported in bf16, then
    s' = float32(that) - 1. Returns (ok, leaves checked, max |s' - s|)."""
    pairs = [(k, got[k], want[k]) for k in got if k != "layers"]
    for lg, lw in zip(got["layers"], want["layers"]):
        pairs += [(k, lg[k], lw[k]) for k in lw]
    ok = len(got["layers"]) == len(want["layers"]) and set(got) == set(want)
    norm_err = 0.0
    for name, g, w in pairs:
        if name in NORM_KEYS:
            expect = (w.float() + 1.0).to(torch.bfloat16).float() - 1.0
            ok = ok and g.dtype == w.dtype and torch.equal(g.float(), expect)
            norm_err = max(norm_err, (g.float() - w.float()).abs().max().item())
        else:
            ok = ok and g.dtype == w.dtype and torch.equal(g, w)
    return ok, len(pairs), norm_err


def timed_load(fn, nbytes):
    """fn() with its seconds to the card and the GB/s of `nbytes`."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    return out, {"seconds": sec, "bytes": nbytes, "gb_per_s": nbytes / sec / 1e9}


def first_diff(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                None if len(a) == len(b) else min(len(a), len(b)))


def logits_at(cfg, params, dev, seq, start):
    from shellac_tpu_torch.models import transformer

    toks = torch.tensor([seq], dtype=torch.int64, device=dev)
    with torch.inference_mode():
        return transformer.forward(cfg, params, toks, device=dev)[0, start:]


def real_generate(seed, dev, tmp, card, tok_dir):
    """shellac-1b with real norm scales, exported through to_state_dict as
    an HF Llama directory (two shards), loaded by from_hf, converted by
    `convert` and served by `generate --native-dir --text`: weights round
    trip, logits and greedy tokens against the source model. Returns the
    native directory and its config."""
    import contextlib
    import io
    import os
    import shutil

    from shellac_tpu_torch import Engine, cli, get_model_config
    from shellac_tpu_torch.models import transformer
    from shellac_tpu_torch.models.convert import config_from_hf, from_hf
    from shellac_tpu_torch.training.tokenizer import HFTokenizer

    cfg = get_model_config("shellac-1b")
    params = transformer.init_params(cfg, seed=seed, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 16)
    norms = [params["final_norm"]] + [lp[n] for lp in params["layers"]
                                      for n in ("attn_norm", "mlp_norm")]
    for t in norms:
        t.copy_(NORM_STD * torch.randn(t.shape, generator=gen, device=dev))
    hf_dir, native = os.path.join(tmp, "hf"), os.path.join(tmp, "native")
    t0 = time.perf_counter()
    nbytes = write_hf(hf_dir, llama_hf_config(cfg), cfg, params)
    export_s = time.perf_counter() - t0
    mapped = config_from_hf(hf_dir)
    fields = ("vocab_size", "d_model", "n_layers", "n_heads", "kv_heads",
              "dim_per_head", "ff_dim", "max_seq_len", "rope_theta",
              "norm_eps", "tie_embeddings", "activation", "attn_window")
    config_ok = all(getattr(mapped, f) == getattr(cfg, f) for f in fields)
    (hcfg, hparams), load_hf = timed_load(
        lambda: from_hf(hf_dir, device=dev), nbytes)
    hf_ok, n_leaves, hf_norm_err = params_round_trip(hparams, params)
    del hparams
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli.main(["convert", "--hf-dir", hf_dir, "--out", native])
    convert_s = time.perf_counter() - t0
    report = json.loads(out.getvalue())
    shutil.rmtree(hf_dir)
    native_bytes = os.path.getsize(os.path.join(native, cli.NATIVE_PARAMS))
    (ncfg, nparams), load_native = timed_load(
        lambda: cli._load_native(native, dev), native_bytes)
    native_ok, _, native_norm_err = params_round_trip(nparams, params)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli.main(["generate", "--native-dir", native, "--tokenizer", tok_dir,
                  "--text", REAL_TEXT, "--max-new", str(REAL_NEW),
                  "--temperature", "0"])
    generate_s = time.perf_counter() - t0
    got = json.loads(out.getvalue())
    tok = HFTokenizer(tok_dir)
    prompt = tok.encode(REAL_TEXT)
    src = Engine(cfg, params, temperature=0.0, device=dev).generate(
        torch.from_numpy(prompt[None].astype(np.int64)).to(dev),
        max_new_tokens=REAL_NEW)
    want = src.tokens[0].tolist()
    seq = list(map(int, prompt)) + want
    ref = logits_at(cfg, params, dev, seq, len(prompt) - 1)
    mine = logits_at(ncfg, nparams, dev, seq, len(prompt) - 1)
    scale = ref.abs().max().item()
    logit_err = (mine - ref).abs().max().item()
    d = first_diff(got["tokens"], want)
    margin = (None if d is None
              else top2_margin(cfg, params, dev, prompt, want[:d]))
    tokens_ok = d is None or margin < 2 * LOGIT_TOL * scale
    ok = (config_ok and hf_ok and native_ok and ncfg == hcfg
          and report["params"] == transformer.num_params(params)
          and bool(torch.isfinite(mine).all().item())
          and logit_err <= LOGIT_TOL * scale and tokens_ok
          and got["text"] == tok.decode(got["tokens"]))
    emit("real-weights", step="shellac-1b", model="shellac-1b",
         norm_std=NORM_STD, hf_dir={"shards": 2, "bytes": nbytes,
                                    "export_s": export_s},
         config_maps_back=config_ok, load_hf_to_card=load_hf,
         convert=dict(report, seconds=convert_s), native_bytes=native_bytes,
         load_native_to_card=load_native, page_cache="warm (just written)",
         leaves_checked=n_leaves, leaves_round_trip=hf_ok and native_ok,
         norm_max_abs_change={"from_hf": hf_norm_err,
                              "native": native_norm_err},
         generate={"seconds": generate_s, "prompt_tokens": len(prompt),
                   "tokens": got["tokens"], "text": got["text"]},
         source_tokens=want, first_diff=d, top2_margin_at_diff=margin,
         logits_max_abs_err=logit_err, logits_scale=scale,
         tol=f"max_abs_err <= {LOGIT_TOL} * max|ref|; tokens equal unless "
             f"the source's top-2 margin < {2 * LOGIT_TOL} * max|ref|",
         ok=ok, card=card)
    del params, nparams, src, ref, mine
    reset_peak()
    if not ok:
        raise SystemExit("real-weights: the shellac-1b round trip through "
                         "the HF directory and convert is not exact")
    return native, cfg


def real_serve(seed, dev, native, cfg, card, tok_dir):
    """`serve --native-dir ... --tokenizer <dir>` (cmd_serve in process,
    its HTTP loop on a thread): concurrent chat completions through the
    directory's chat template, each one's server TTFT and TPOT, and one
    response_format JSON-schema request over the BPE vocab; the DFA's
    compile ms and states over the vocab."""
    import threading

    from shellac_tpu_torch import cli
    from shellac_tpu_torch.inference import server as server_mod
    from shellac_tpu_torch.inference.constraints import (
        compile_token_dfa,
        constraint_pattern,
    )
    from shellac_tpu_torch.training.tokenizer import HFTokenizer

    tok = HFTokenizer(tok_dir)
    t0 = time.perf_counter()
    dfa = compile_token_dfa(constraint_pattern({"json_schema": CON_SCHEMA}),
                            tok, cfg.vocab_size, tok.eos_token_id)
    dfa_ms = (time.perf_counter() - t0) * 1e3
    handles = {}

    def start(c, p, *, host, port, tokenizer, **kw):
        srv = server_mod.InferenceServer(c, p, tokenizer=tokenizer, **kw)
        httpd = server_mod.make_http_server(srv, host, port)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        handles.update(srv=srv, httpd=httpd)

    serve = server_mod.serve
    server_mod.serve = start
    t0 = time.perf_counter()
    try:
        cli.main(["serve", "--native-dir", native, "--tokenizer", tok_dir,
                  "--cache-backend", "paged", "--slots", str(SLOTS),
                  "--port", "0", "--eos-id", str(tok.eos_token_id),
                  "--seed", str(seed)])
    finally:
        server_mod.serve = serve
    up_s = time.perf_counter() - t0
    srv, httpd = handles["srv"], handles["httpd"]
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    topics = ["kernels", "graphs", "caches", "batching", "tokenizers",
              "checkpoints", "routers", "schedulers"]
    chats = [[{"role": "system", "content": "Answer in one line."},
              {"role": "user", "content": f"Tell me about {t}."}]
             for t in topics[:REAL_CHATS]]
    # A chat template's first render compiles it; later ones reuse it.
    fresh, template_ms = HFTokenizer(tok_dir), []
    for _ in range(2):
        t1 = time.perf_counter()
        fresh.apply_chat_template(chats[0], add_generation_prompt=True)
        template_ms.append((time.perf_counter() - t1) * 1e3)
    got = {}

    def post(i, body):
        t1 = time.perf_counter()
        status, hdr, raw, _ = http_call(base, "/v1/chat/completions", body)
        got[i] = (status, hdr.get("x-request-id"), raw,
                  time.perf_counter() - t1)

    def round_of_chats(tag):
        calls = [threading.Thread(target=post, args=((tag, i), {
            "messages": m, "max_tokens": REAL_CHAT_TOKENS}))
            for i, m in enumerate(chats)]
        for t in calls:
            t.start()
        for t in calls:
            t.join(timeout=600)

    try:
        # The first round captures the engine's graphs (each prefill
        # bucket on its second use, the window variants) and warms
        # cuBLAS: its TTFT is a cold start. The second round is timed.
        round_of_chats("cold")
        round_of_chats("warm")
        post("json", {"messages": chats[0], "max_tokens": 128,
                      "response_format": {"type": "json_schema",
                                          "json_schema": {
                                              "name": "w",
                                              "schema": CON_SCHEMA}}})
        timelines, prompt_ok = {"cold": [], "warm": []}, True
        for tag in timelines:
            for i, m in enumerate(chats):
                status, rid, raw, wall = got.get((tag, i),
                                                 (None, None, b"", None))
                if status != 200:
                    prompt_ok = False
                    continue
                body = json.loads(raw)
                t1 = time.perf_counter()
                want_prompt = len(tok.encode(tok.apply_chat_template(
                    m, add_generation_prompt=True)))
                render_s = time.perf_counter() - t1
                prompt_ok = (prompt_ok and body["usage"]["prompt_tokens"]
                             == want_prompt)
                _, _, ev_raw, _ = http_call(base, f"/debug/request/{rid}")
                ev = {e["event"]: e for e in json.loads(ev_raw)["events"]}
                ttft = ev["first-token"]["ttft_s"]
                wait = ev["prefill"]["queue_wait_s"]
                e2e, n = ev["finish"]["e2e_s"], ev["finish"]["n_tokens"]
                # The server's clock starts once the handler has rendered
                # and tokenized the prompt: TTFT is the queue wait, then
                # the prefill to the first token. What the client waits
                # beyond e2e is the handler's (render, tokenize, HTTP).
                timelines[tag].append({
                    "ttft_ms": ttft * 1e3, "queue_wait_ms": wait * 1e3,
                    "prefill_ms": (ttft - wait) * 1e3,
                    "pending_at_admit": ev["admit"]["pending"],
                    "handler_ms": (wall - e2e) * 1e3,
                    "render_encode_ms": render_s * 1e3,
                    "wall_ms": wall * 1e3,
                    "tpot_ms": (e2e - ttft) / max(n - 1, 1) * 1e3,
                    "tokens": n})
        status, _, raw, _ = got.get("json", (None, None, b"", None))
        content = (json.loads(raw)["choices"][0]["message"]["content"]
                   if status == 200 else None)
        try:
            json_ok = content is not None and schema_ok(json.loads(content))
        except ValueError:
            json_ok = False
        _, _, metrics, _ = http_call(base, "/metrics")
        text = metrics.decode()
        server_compile_s = metric_value(
            text, "shellac_constraint_compile_seconds_sum")
        # The window a decode step runs (the startup autotuner's choice)
        # and the admissions a step takes.
        sched = {"decode_ticks": srv.engine.decode_ticks,
                 "max_prefills_per_step": srv.engine.max_prefills_per_step,
                 "overlap_decode": srv.engine.overlap_decode,
                 "overlap_prefill": srv.engine.overlap_prefill}
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.close()
    def p50_99(tag, key):
        xs = [t[key] for t in timelines[tag]]
        return {"p50": pct(xs, 50), "p99": pct(xs, 99)} if xs else None

    ok = (all(len(t) == REAL_CHATS for t in timelines.values())
          and prompt_ok and json_ok and dfa.n_states > 0)
    emit("real-weights", step="serve", command="serve --native-dir <tmp> "
         f"--tokenizer {'/'.join(TOKENIZER_DIR)} --cache-backend paged "
         f"--slots {SLOTS} --port 0 --eos-id {tok.eos_token_id}",
         seconds_to_serving=up_s, tokenizer_vocab=tok.vocab_size,
         chat_requests={k: len(v) for k, v in timelines.items()},
         chat_prompt_tokens_match=prompt_ok,
         chat_ttft_ms={k: p50_99(k, "ttft_ms") for k in timelines},
         chat_queue_wait_ms={k: p50_99(k, "queue_wait_ms")
                             for k in timelines},
         chat_prefill_ms={k: p50_99(k, "prefill_ms") for k in timelines},
         chat_handler_ms={k: p50_99(k, "handler_ms") for k in timelines},
         scheduling=sched,
         chat_template_ms={"first": template_ms[0],
                           "again": template_ms[1]},
         chat_tpot_ms={k: p50_99(k, "tpot_ms") for k in timelines},
         chats=timelines,
         json_schema={"status": status, "content": content, "ok": json_ok},
         dfa={"compile_ms": dfa_ms, "states": dfa.n_states,
              "vocab": cfg.vocab_size, "tokenizer_vocab": tok.vocab_size,
              "server_compile_s": server_compile_s},
         ok=ok, card=card)
    reset_peak()
    if not ok:
        raise SystemExit("real-weights: serving with the HF tokenizer's chat "
                         "template or its JSON-schema constraint failed")


def real_checkpoint(seed, dev, tmp, card):
    """The train recipe's state (shellac-1b, fp32 masters, AdamW) through
    the Checkpointer on the card: an asynchronous save (call and commit
    seconds), a restore onto the card, one train step from the restored
    state against one from the live state (bit for bit), then a corrupted
    newest step that restore(fallback=True) walks past."""
    import os

    from shellac_tpu_torch import get_model_config
    from shellac_tpu_torch.training import (
        TrainConfig,
        init_train_state,
        make_train_step,
    )
    from shellac_tpu_torch.training.checkpoint import (
        ITEM,
        Checkpointer,
        abstract_train_state,
    )
    from shellac_tpu_torch.training.train_state import named_leaves

    cfg = get_model_config("shellac-1b")
    tcfg = TrainConfig(warmup_steps=10, total_steps=1000)
    state = init_train_state(cfg, tcfg, seed=seed, device=dev)
    step = make_train_step(cfg, tcfg, device=dev)
    batch = train_batch(seed + 1, cfg.vocab_size, 2, 512, dev)
    state, _ = step(state, batch)  # moments and count no longer zero
    torch.cuda.synchronize()
    ck = Checkpointer(os.path.join(tmp, "ckpt"), max_to_keep=3)
    t0 = time.perf_counter()
    ck.save(1, state)
    call_s = time.perf_counter() - t0
    ck.wait()
    commit_s = time.perf_counter() - t0
    nbytes = os.path.getsize(os.path.join(tmp, "ckpt", "1", ITEM))
    kept = {"step": state.step,
            "embed": state.params["embed"].detach().clone(),
            "nu.wq": state.opt_state.nu["layers"][0]["wq"].clone()}
    abstract = abstract_train_state(cfg, tcfg)
    (restored, restore) = timed_load(
        lambda: ck.restore(abstract_state=abstract, device=dev), nbytes)
    live_next, m_live = step(state, batch)
    rest_next, m_rest = step(restored, batch)

    def leaves(s):
        return ([s.step, s.opt_state.count]
                + [x for _, x in named_leaves(s.params)]
                + [x for _, x in named_leaves(s.opt_state.mu)]
                + [x for _, x in named_leaves(s.opt_state.nu)])

    pairs = list(zip(leaves(live_next), leaves(rest_next)))
    differ = sum(not (torch.equal(a, b) if isinstance(a, torch.Tensor)
                      else a == b) for a, b in pairs)
    loss_equal = m_live["loss"].item() == m_rest["loss"].item()
    del restored, rest_next
    reset_peak()
    ck.save(2, live_next, wait=True)
    item = os.path.join(tmp, "ckpt", "2", ITEM)
    with open(item, "r+b") as f:  # a torn write: the second half gone
        f.truncate(os.path.getsize(item) // 2)
    t0 = time.perf_counter()
    fb = ck.restore(abstract_state=abstract, device=dev, fallback=True)
    torch.cuda.synchronize()
    fallback_s = time.perf_counter() - t0
    fb_ok = (ck.latest_step() == 1
             and os.path.isdir(os.path.join(tmp, "ckpt", "2.corrupt"))
             and fb.step == kept["step"]
             and torch.equal(fb.params["embed"],
                                              kept["embed"])
             and torch.equal(fb.opt_state.nu["layers"][0]["wq"],
                             kept["nu.wq"]))
    ok = differ == 0 and loss_equal and fb_ok
    emit("real-weights", step="checkpoint", model="shellac-1b",
         state="fp32 masters, adamw mu (bf16) and nu (fp32), after one step",
         checkpoint_bytes=nbytes, save_call_s=call_s, save_commit_s=commit_s,
         save_gb_per_s=nbytes / commit_s / 1e9, restore_to_card=restore,
         page_cache="warm (just written)", leaves_compared=len(pairs),
         leaves_differing_after_a_step=differ,
         loss={"live": m_live["loss"].item(), "restored": m_rest["loss"].item()},
         fallback={"landed_on": ck.latest_step(), "seconds": fallback_s,
                   "ok": fb_ok}, ok=ok, card=card)
    del state, live_next, fb, kept
    reset_peak()
    if not ok:
        raise SystemExit("real-weights: a step from the restored state is "
                         "not the live step's, or the fallback restore "
                         "missed the intact step")


def real_gptoss(seed, dev, tmp, card):
    """2 layers of GPT-OSS-20B at full width, the config built from the
    published keys through config_from_hf, with the values a bf16
    checkpoint holds: exported in GPT-OSS's HF key layout (fused
    interleaved gate_up, router, sinks, biases), read back by from_hf,
    every leaf bit-equal, the logits and greedy tokens of Engine equal."""
    import os
    import shutil

    from shellac_tpu_torch import Engine
    from shellac_tpu_torch.models import transformer
    from shellac_tpu_torch.models.convert import (
        HFConfig,
        config_from_hf,
        from_hf,
    )

    hf_config = dict(GPTOSS_20B_HF, num_hidden_layers=2,
                     layer_types=GPTOSS_20B_HF["layer_types"][:2])
    cfg = gptoss_20b().replace(n_layers=2)
    config_ok = config_from_hf(HFConfig(hf_config)).replace(
        remat=False) == cfg
    params = transformer.init_params(cfg, seed=seed, device=dev)
    # The values a bf16 checkpoint holds: the leaves the port keeps in
    # fp32 (router, its bias, sinks) rounded through bf16 first; the norm
    # scales stay zeros, which round trip exactly.
    for lp in params["layers"]:
        for name in ("w_router", "b_router", "sinks"):
            lp[name].copy_(lp[name].to(torch.bfloat16).float())
    path = os.path.join(tmp, "gptoss")
    t0 = time.perf_counter()
    nbytes = write_hf(path, hf_config, cfg, params)
    export_s = time.perf_counter() - t0
    reset_peak()
    (lcfg, lparams), load = timed_load(lambda: from_hf(path, device=dev),
                                       nbytes)
    shutil.rmtree(path)
    exact, n_leaves, _ = params_round_trip(lparams, params)
    prompt = np.random.default_rng(seed + 20).integers(
        0, cfg.vocab_size, 64).tolist()
    ref = logits_at(cfg, params, dev, prompt, 0)
    mine = logits_at(lcfg.replace(remat=False), lparams, dev, prompt, 0)
    scale = ref.abs().max().item()
    err = (mine - ref).abs().max().item()
    toks = torch.tensor([prompt], dtype=torch.int64, device=dev)
    a = Engine(cfg, params, temperature=0.0, device=dev).generate(
        toks, max_new_tokens=8).tokens[0].tolist()
    b = Engine(lcfg, lparams, temperature=0.0, device=dev).generate(
        toks, max_new_tokens=8).tokens[0].tolist()
    ok = (config_ok and exact and err <= LOGIT_TOL * scale and a == b
          and bool(torch.isfinite(mine).all().item()))
    emit("real-weights", step="gptoss", model="GPT-OSS-20B, 2 layers",
         params=transformer.num_params(params), config_from_published=config_ok,
         hf_dir={"shards": 2, "bytes": nbytes, "export_s": export_s},
         load_hf_to_card=load, page_cache="warm (just written)",
         leaves_checked=n_leaves, leaves_bit_equal=exact,
         logits_max_abs_err=err, logits_scale=scale, greedy_tokens=b,
         greedy_equal=a == b, ok=ok, card=card)
    del params, lparams, ref, mine
    reset_peak()
    if not ok:
        raise SystemExit("real-weights: GPT-OSS's key layout does not round "
                         "trip through from_hf")


def phase_real_weights(seed, dev, table, card):
    """The real-weights path: shellac-1b through an HF directory, convert
    and generate --native-dir; serve --native-dir with the fixture's
    tokenizer over HTTP; the Checkpointer on the train recipe's state;
    GPT-OSS's key layout. Everything is written under one temporary
    directory, removed at the end. Returns the kernel launches of the
    path (kernels 1, 2 and 5 in generate, 1, 2 and 7 in serve, 1-4 in the
    train steps)."""
    import os
    import shutil
    import tempfile

    tok_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           *TOKENIZER_DIR)
    tmp = tempfile.mkdtemp(prefix="shellac-real-weights-")
    reset_peak()
    reset_counts(table)
    try:
        native, cfg = real_generate(seed, dev, tmp, card, tok_dir)
        real_serve(seed, dev, native, cfg, card, tok_dir)
        real_checkpoint(seed, dev, tmp, card)
        real_gptoss(seed, dev, tmp, card)
        counts = read_counts(table)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("real-weights", step="main_path", launches=counts,
         disk_removed=not os.path.exists(tmp), card=card)
    return counts


def eager_ms(fn, arg_sets, iters):
    """Mean ms per eager call by CUDA events, cycling through arg_sets.
    Includes the host's launch cost wherever that outruns the device."""
    for a in arg_sets:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(fn, arg_sets, iters):
    """Mean device ms per call: `iters` calls (cycling arg_sets) captured
    in one CUDA graph, replayed, timed by CUDA events. No host launch
    cost is left in it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for a in arg_sets:
            fn(*a)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / iters
    del graph
    return ms


def copies(make, min_bytes=256 << 20, nbytes=None):
    """Input sets to cycle through so that one pass moves at least
    `min_bytes` (at most 16 sets): `nbytes` a call reads, by default every
    byte of the first set."""
    first = make()
    if nbytes is None:
        nbytes = sum(t.numel() * t.element_size() for t in first
                     if isinstance(t, torch.Tensor))
    n = max(1, -(-min_bytes // max(nbytes, 1)))
    return [first] + [make() for _ in range(min(n, 16) - 1)]


def bound(nbytes, flops, dtype):
    tb, tf = nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS_S[dtype]
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def phase_timings(gen, dev, shapes, card):
    from shellac_tpu_torch.inference.cache import (
        paged_gather_layer,
        paged_gather_scales,
    )
    from shellac_tpu_torch.ops.decode_attention import (
        _decode_ref,
        _dequantize,
        _paged_decode_ref,
        decode_attention_cuda,
        decode_attention_quant_cuda,
        paged_decode_attention_cuda,
        paged_decode_attention_quant_cuda,
    )
    from shellac_tpu_torch.ops.flash_attention import (
        flash_attention_cuda,
        flash_attention_ref,
        flash_bwd_dkdv_cuda,
        flash_bwd_dkdv_ref,
        flash_bwd_dq_cuda,
        flash_bwd_dq_ref,
        flash_forward_ref,
    )
    from shellac_tpu_torch.ops.norms import rms_norm_cuda, rms_norm_ref

    bf = torch.bfloat16
    rows_out = {}

    def measure(fn, sets, iters):
        return graph_ms(fn, sets, iters), eager_ms(fn, sets, iters)

    def measure_eager(fn, sets, iters):
        """For calls that allocate gigabytes (the plain versions at the
        training shape) or run autograd: CUDA events around eager calls."""
        ms = eager_ms(fn, sets, iters)
        return ms, ms

    def record(name, case, kernel, plain, library, nbytes, flops, shape,
               calls=None):
        """`library` times one PyTorch call computing the same function;
        where none exists it is None and `calls` = (key, what, times) may
        time the nearest library route of several calls."""
        bms, by = bound(nbytes, flops, bf)
        row = {"ms": kernel[0], "plain_ms": plain[0], "bound_ms": bms,
               "bound_by": by,
               "library_ms": None if library is None else library[0],
               "shape": shape}
        extra = {}
        if library is not None:
            extra["library_eager_ms"] = library[1]
        if calls is not None:
            key, what, times = calls
            row[key] = times[0]
            row[key + "_what"] = what
            extra[key.replace("_ms", "_eager_ms")] = times[1]
        emit("timings", kernel=name, case=case, dtype="bf16",
             bytes=nbytes, flops=flops, roofline_share=bms / kernel[0],
             achieved_tflops=flops / (kernel[0] * 1e-3) / 1e12,
             peaks=f"{BF16_PEAK_NAME}; {PEAK_BYTES_S / 1e12} TB/s",
             eager_ms=kernel[1], plain_eager_ms=plain[1], card=card,
             **extra, **row)
        rows_out.setdefault(name, row)

    for case in ("rms_prefill", "rms_decode", "rms_train",
                 "rms_serve_decode"):
        rows, d = shapes[case]

        def make():
            x, sc = rms_inputs(gen, rows, d, bf, dev)
            return x, sc, (1.0 + sc).to(bf)  # the library call's weight

        sets = copies(make)
        k = measure(lambda x, s, w: rms_norm_cuda(x, s, 1e-5), sets, 200)
        p = measure(lambda x, s, w: rms_norm_ref(x, s, 1e-5), sets, 50)
        lib = measure(lambda x, s, w: F.rms_norm(x, (d,), w, 1e-5), sets, 200)
        record("rms_norm", case, k, p, lib, 2 * rows * d * 2 + d * 4,
               4 * rows * d, [rows, d])

    fs = shapes["flash"]
    b, s, h, hkv, d = fs["b"], fs["s"], fs["h"], fs["hkv"], fs["d"]
    sets = copies(lambda: flash_inputs(gen, bf, dev, **fs))
    k = measure(lambda q, k, v: flash_attention_cuda(q, k, v), sets, 20)
    p = measure(lambda q, k, v: flash_attention_ref(q, k, v), sets[:2], 4)
    lib = measure(
        lambda q, k, v: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True),
        sets, 20)
    pairs = b * h * s * (s + 1) // 2  # causal (q, k) pairs this run needs
    record("flash_attention_fwd", "main_causal", k, p, lib,
           (2 * b * s * h * d + 2 * b * s * hkv * d) * 2, 4 * d * pairs,
           [b, s, h, hkv, d])

    # Serve's largest admission: one prompt, B = 1, its largest launcher.
    fs = shapes["flash_serve"]
    b, s, h, hkv, d = fs["b"], fs["s"], fs["h"], fs["hkv"], fs["d"]
    sets = copies(lambda: flash_inputs(gen, bf, dev, **fs))
    k = measure(lambda q, k, v: flash_attention_cuda(q, k, v), sets, 50)
    p = measure(lambda q, k, v: flash_attention_ref(q, k, v), sets[:2], 4)
    lib = measure(
        lambda q, k, v: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True),
        sets, 50)
    pairs = b * h * s * (s + 1) // 2
    record("flash_attention_fwd", "serve_b1_s1024", k, p, lib,
           (2 * b * s * h * d + 2 * b * s * hkv * d) * 2, 4 * d * pairs,
           [b, s, h, hkv, d])

    # The training shape: kernel 2 with its lse, kernels 3 and 4.
    ts = shapes["train"]
    b, s, h, hkv, d = ts["b"], ts["s"], ts["h"], ts["hkv"], ts["d"]

    def make_train():
        q, k, v = flash_inputs(gen, bf, dev, b, s, h, hkv, d)
        do = randn(gen, (b, s, h, d), bf, dev)
        out, lse = flash_attention_cuda(q, k, v, with_lse=True)
        delta = torch.einsum("bshd,bshd->bhs", do.float(),
                             out.float()).contiguous()
        return q, k, v, do, lse, delta

    sets = copies(make_train)
    pairs = b * h * s * (s + 1) // 2
    qbytes, kbytes, rowbytes = b * s * h * d * 2, b * s * hkv * d * 2, \
        b * h * s * 4
    shape = [b, s, h, hkv, d]
    k = measure(lambda q, k, v, do, lse, dl: flash_attention_cuda(
        q, k, v, with_lse=True), sets, 10)
    p = measure_eager(lambda q, k, v, do, lse, dl: flash_forward_ref(
        q, k, v), sets[:1], 2)
    lib = measure(
        lambda q, k, v, do, lse, dl: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True),
        sets, 10)
    record("flash_attention_fwd", "train_causal_with_lse", k, p, lib,
           2 * qbytes + 2 * kbytes + rowbytes, 4 * d * pairs, shape)

    def sdpa_graph(q, k, v, do, lse, dl):
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True)
        return qt, kt, vt, out, do.transpose(1, 2)

    lib_sets = [sdpa_graph(*a) for a in sets]
    # One backward call of SDPA computes dq, dk and dv: kernels 3 and 4
    # together. Timed eagerly (autograd is not captured).
    lib = measure_eager(lambda qt, kt, vt, out, dot: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), lib_sets, 10)
    del lib_sets
    k = measure(lambda q, k, v, do, lse, dl: flash_bwd_dkdv_cuda(
        q, k, v, do, lse, dl), sets, 10)
    p = measure_eager(lambda q, k, v, do, lse, dl: flash_bwd_dkdv_ref(
        q, k, v, do, lse, dl), sets[:1], 2)
    record("flash_attention_bwd_dkdv", "train_causal", k, p, lib,
           2 * qbytes + 4 * kbytes + 2 * rowbytes, 8 * d * pairs, shape)
    k = measure(lambda q, k, v, do, lse, dl: flash_bwd_dq_cuda(
        q, k, v, do, lse, dl), sets, 10)
    p = measure_eager(lambda q, k, v, do, lse, dl: flash_bwd_dq_ref(
        q, k, v, do, lse, dl), sets[:1], 2)
    record("flash_attention_bwd_dq", "train_causal", k, p, lib,
           3 * qbytes + 2 * kbytes + 2 * rowbytes, 6 * d * pairs, shape)
    del sets
    torch.cuda.empty_cache()

    # Kernel 5 at generate's step and with every slot live to L. A step
    # reads only the live rows, so the sets cycled count those against
    # the L2.
    for case, ds in (("main_ragged", shapes["decode"]),
                     ("full_live", {**shapes["decode"],
                                    "index": torch.full_like(
                                        shapes["decode"]["index"],
                                        MAX_LEN - 1)})):
        b, h, hkv, L, d, idx = (ds["b"], ds["h"], ds["hkv"], ds["L"],
                                ds["d"], ds["index"])
        live = int((idx + 1).sum().item())  # kv positions this step reads
        nbytes = 2 * b * h * d * 2 + 2 * live * hkv * d * 2 + b * 4
        sets = copies(lambda: decode_inputs(gen, bf, dev, **ds),
                      nbytes=nbytes)
        mask = (torch.arange(L, device=dev)[None, :]
                < (idx + 1)[:, None].long())[:, None, None, :]
        k = measure(lambda q, ck, cv, i: decode_attention_cuda(q, ck, cv, i),
                    sets, 200)
        p = measure(lambda q, ck, cv, i: _decode_ref(q, ck, cv, i, None,
                                                     d ** -0.5), sets, 50)
        lib = measure(
            lambda q, ck, cv, i: F.scaled_dot_product_attention(
                q.transpose(1, 2), ck, cv, attn_mask=mask, enable_gqa=True),
            sets, 200)
        record("decode_attention_dense", case, k, p, lib, nbytes,
               4 * d * h * live, [b, 1, h, hkv, L, d])
        del sets
        torch.cuda.empty_cache()

    # Kernel 7 at serve's step (16 slots, 16-token blocks) and with every
    # slot live to 2048.
    ps = shapes["paged"]
    for case, idx in (("serve_ragged", ps["index"]),
                      ("full_live", torch.full_like(ps["index"],
                                                    MAX_LEN - 1))):
        p = {**ps, "index": idx}
        b, h, hkv, d, bs, mb = (len(idx), ps["h"], ps["hkv"], ps["d"],
                                ps["bs"], ps["max_blocks"])
        sets = copies(lambda: paged_inputs(gen, bf, dev, **p)[:5])
        live = int((idx + 1).sum().item())
        mask = (torch.arange(mb * bs, device=dev)[None, :]
                < (idx + 1)[:, None].long())[:, None, None, :]

        def gather_sdpa(q, pk, pv, tab, i):
            kk, vv = paged_gather_layer(pk, pv, tab)
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), kk, vv, attn_mask=mask, enable_gqa=True)

        k = measure(lambda q, pk, pv, tab, i: paged_decode_attention_cuda(
            q, pk, pv, tab, i), sets, 200)
        p_ms = measure(lambda q, pk, pv, tab, i: _paged_decode_ref(
            q, pk, pv, tab, i, None, d ** -0.5), sets, 20)
        two = measure(gather_sdpa, sets, 50)
        # Bytes: q and out, the live k/v rows, the live table entries,
        # index.
        pages = int(((idx + 1 + bs - 1) // bs).sum().item())
        record("paged_decode_attention", case, k, p_ms, None,
               2 * b * h * d * 2 + 2 * live * hkv * d * 2 + pages * 4
               + b * 4, 4 * d * h * live, [b, 1, h, hkv, bs, mb, d],
               calls=("library_two_calls_ms", "gather + SDPA", two))
        del sets
        torch.cuda.empty_cache()

    # Kernel 6 at the generate-int8 shape and with every slot live to L.
    # Bytes: q and out, the live int8 k/v rows and their fp32 scales
    # (2 D + 8 bytes per position and kv head), index.
    ds = shapes["decode"]
    for case, idx in (("generate_int8_ragged", ds["index"]),
                      ("full_live_int8", torch.full_like(ds["index"],
                                                         MAX_LEN - 1))):
        p = {**ds, "index": idx}
        b, h, hkv, L, d = ds["b"], ds["h"], ds["hkv"], ds["L"], ds["d"]
        live = int((idx + 1).sum().item())
        nbytes = 2 * b * h * d * 2 + live * hkv * (2 * d + 8) + b * 4
        sets = copies(lambda: decode_quant_inputs(gen, bf, dev, **p),
                      nbytes=nbytes)
        mask = (torch.arange(L, device=dev)[None, :]
                < (idx + 1)[:, None].long())[:, None, None, :]

        def dequant_sdpa(q, ck, cv, ks, vs, i):
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), _dequantize(ck, ks, bf),
                _dequantize(cv, vs, bf), attn_mask=mask, enable_gqa=True)

        k = measure(lambda q, ck, cv, ks, vs, i: decode_attention_quant_cuda(
            q, ck, cv, ks, vs, i), sets, 200)
        p_ms = measure(lambda q, ck, cv, ks, vs, i: _decode_ref(
            q, ck, cv, i, None, d ** -0.5, k_scale=ks, v_scale=vs), sets, 20)
        two = measure(dequant_sdpa, sets, 50)
        record("decode_attention_dense_int8", case, k, p_ms, None, nbytes,
               4 * d * h * live, [b, 1, h, hkv, L, d],
               calls=("library_two_calls_ms",
                      "dequantize k and v (fp32 multiply, bf16 cast) + SDPA",
                      two))
        del sets
        torch.cuda.empty_cache()

    # Kernel 7's int8 branch at serve-int8's step (64-token blocks) and
    # with every slot live to 2048.
    ps = shapes["paged_int8"]
    for case, idx in (("serve_int8_ragged", ps["index"]),
                      ("full_live_int8", torch.full_like(ps["index"],
                                                         MAX_LEN - 1))):
        p = {**ps, "index": idx}
        b, h, hkv, d, bs, mb = (len(idx), ps["h"], ps["hkv"], ps["d"],
                                ps["bs"], ps["max_blocks"])
        sets = copies(lambda: paged_quant_inputs(gen, bf, dev, **p)[:7])
        live = int((idx + 1).sum().item())
        mask = (torch.arange(mb * bs, device=dev)[None, :]
                < (idx + 1)[:, None].long())[:, None, None, :]

        def gather_dequant_sdpa(q, pk, pv, pks, pvs, tab, i):
            kk, vv = paged_gather_layer(pk, pv, tab)
            kk = _dequantize(kk, paged_gather_scales(pks, tab), bf)
            vv = _dequantize(vv, paged_gather_scales(pvs, tab), bf)
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), kk, vv, attn_mask=mask, enable_gqa=True)

        k = measure(lambda q, pk, pv, pks, pvs, tab, i:
                    paged_decode_attention_quant_cuda(q, pk, pv, pks, pvs,
                                                      tab, i), sets, 200)
        p_ms = measure(lambda q, pk, pv, pks, pvs, tab, i: _paged_decode_ref(
            q, pk, pv, tab, i, None, d ** -0.5, k_scale=pks, v_scale=pvs),
            sets, 20)
        three = measure(gather_dequant_sdpa, sets, 50)
        # Bytes: q and out, the live int8 k/v rows and their fp32 scales
        # (2 D + 8 bytes per position and kv head), the live table
        # entries, index.
        pages = int(((idx + 1 + bs - 1) // bs).sum().item())
        record("paged_decode_attention_int8", case, k, p_ms, None,
               2 * b * h * d * 2 + live * hkv * (2 * d + 8) + pages * 4
               + b * 4, 4 * d * h * live, [b, 1, h, hkv, bs, mb, d],
               calls=("library_three_calls_ms",
                      "gather + dequantize k and v + SDPA", three))
        del sets
        torch.cuda.empty_cache()
    return rows_out


# --------------------------------------------------------------------------


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", default=None,
                    help="comma-separated phases to run after the build "
                         "(generate, prefix-serve, sampling-controls, "
                         "constrained-serve, graph-parity, beam, "
                         "beam-parity, kernels-beam, moe, moe-parity, "
                         "graph-parity-moe, kernels-moe, real-weights, "
                         "mla, mla-parity, kernels-mla, kernels-train, "
                         "train-families, train-options, train-parity, "
                         "cli-train); "
                         "prints no "
                         "kernels line and no ok line")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from shellac_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    emit("device", kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=card,
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])

    t0 = time.perf_counter()
    info = _build.build_info()
    spills = spill_report(info["ptxas"])
    emit("build", seconds=time.perf_counter() - t0, built=info["built"],
         nvcc_seconds=info["seconds"], dir=info["dir"], redesigned=spills,
         ptxas=info["ptxas"])
    bad = [k for k in spills["instances"] if k["spill_stores"] != 0]
    if spills["c7520"] or bad or spills["counts"] != REDESIGNED:
        raise SystemExit(f"build: redesigned kernels spill, serialize or "
                         f"are missing: {spills}")

    table = kernel_table()
    if args.only:
        only_phases = {
            "generate": lambda: phase_generate(args.seed, dev, table, card),
            "prefix-serve": lambda: phase_prefix_serve(args.seed, dev, table,
                                                       card),
            "sampling-controls": lambda: phase_sampling_controls(
                args.seed, dev, table, card),
            "constrained-serve": lambda: phase_constrained_serve(
                args.seed, dev, table, card),
            "graph-parity": lambda: phase_graph_parity(args.seed, dev,
                                                       table),
            "beam": lambda: phase_beam(args.seed, dev, table, card),
            "beam-parity": lambda: phase_beam_parity(args.seed, dev, table),
            "kernels-beam": lambda: phase_kernels_beam(gen, dev),
            "moe": lambda: phase_moe(args.seed, dev, table, card),
            "moe-parity": lambda: phase_moe_parity(args.seed, dev),
            "graph-parity-moe": lambda: phase_graph_parity_moe(
                args.seed, dev, table),
            "kernels-moe": lambda: phase_kernels_moe(
                gen, dev, main_shapes(args.seed, dev), card),
            "real-weights": lambda: phase_real_weights(args.seed, dev,
                                                       table, card),
            "mla": lambda: phase_mla(args.seed, dev, table, card),
            "mla-parity": lambda: phase_mla_parity(args.seed, dev),
            "kernels-mla": lambda: phase_kernels_mla(
                gen, dev, main_shapes(args.seed, dev), card),
            "kernels-train": lambda: (
                phase_kernels_train(gen, dev, main_shapes(args.seed, dev)),
                phase_kernels_train_192(gen, dev, card)),
            "train-families": lambda: phase_train_families(
                args.seed, dev, table, card),
            "train-options": lambda: phase_train_options(
                args.seed, dev, table, card),
            "train-parity": lambda: (phase_train_parity(args.seed, dev),
                                     phase_train_parity_families(
                                         args.seed, dev)),
            "cli-train": lambda: phase_cli_train(args.seed, dev, card),
        }
        gen = torch.Generator(device=dev)
        gen.manual_seed(args.seed)
        for name in args.only.split(","):
            only_phases[name]()
        return 0
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    shapes = main_shapes(args.seed, dev)
    errs = phase_kernels(gen, dev, shapes)
    errs.update(phase_kernels_int8(gen, dev, shapes))
    errs.update(phase_kernels_train(gen, dev, shapes))
    train192_errs, train192_times = phase_kernels_train_192(gen, dev, card)
    phase_kernels_beam(gen, dev)
    phase_kernels_moe(gen, dev, shapes, card)
    mla_errs, mla_times = phase_kernels_mla(gen, dev, shapes, card)
    # The main paths, each with the counts set to 0 just before it; every
    # kernel of a path must have launched in its run.
    gen_counts, bf16_tokens = phase_generate(args.seed, dev, table, card)
    paths = {"generate": gen_counts,
             "generate-int8": phase_generate_int8(args.seed, dev, table,
                                                  card, bf16_tokens)}
    paths["serve"], serve_ref = phase_serve(args.seed, dev, table, card)
    paths["serve-int8"], _ = phase_serve(args.seed, dev, table, card,
                                         backend="paged-int8")
    paths["serve-overlap"] = phase_serve_overlap(args.seed, dev, table,
                                                 card, serve_ref)
    paths["http-serve"] = phase_http_serve(args.seed, dev, table, card,
                                           serve_ref)
    paths["prefix-serve"] = phase_prefix_serve(args.seed, dev, table, card)
    paths["sampling-controls"] = phase_sampling_controls(args.seed, dev,
                                                         table, card)
    paths["constrained-serve"] = phase_constrained_serve(args.seed, dev,
                                                         table, card)
    paths["beam"] = phase_beam(args.seed, dev, table, card)
    paths["train"] = phase_train(args.seed, dev, table, card)
    paths["moe"] = phase_moe(args.seed, dev, table, card)
    paths["real-weights"] = phase_real_weights(args.seed, dev, table, card)
    paths["mla"] = phase_mla(args.seed, dev, table, card)
    families, mla_packed = phase_train_families(args.seed, dev, table, card)
    paths["train-families"] = {
        n: sum(c[n] for c in families.values()) + mla_packed[n]
        for n in mla_packed}
    paths["train-options"] = phase_train_options(args.seed, dev, table,
                                                 card)
    decode = ("rms_norm", "flash_attention_fwd")
    trained = ("rms_norm", "flash_attention_fwd", "flash_attention_bwd_dkdv",
               "flash_attention_bwd_dq")
    for path, kinds in (("generate", decode + ("decode_attention_dense",)),
                        ("generate-int8",
                         decode + ("decode_attention_dense_int8",)),
                        ("serve", decode + ("paged_decode_attention",)),
                        ("serve-int8",
                         decode + ("paged_decode_attention_int8",)),
                        ("serve-overlap",
                         decode + ("paged_decode_attention",)),
                        ("http-serve", decode + ("paged_decode_attention",)),
                        ("prefix-serve",
                         decode + ("paged_decode_attention",)),
                        ("sampling-controls",
                         decode + ("paged_decode_attention",)),
                        ("constrained-serve",
                         decode + ("paged_decode_attention",
                                   "paged_decode_attention_int8")),
                        ("beam", decode + ("decode_attention_dense",
                                           "decode_attention_dense_int8",
                                           "paged_decode_attention",
                                           "paged_decode_attention_int8")),
                        ("moe", decode + ("decode_attention_dense",
                                          "paged_decode_attention")),
                        ("mla", decode + (
                            "decode_attention_dense",
                            "decode_attention_dense_int8",
                            "paged_decode_attention",
                            "paged_decode_attention_int8")),
                        ("real-weights", decode + (
                            "decode_attention_dense", "paged_decode_attention",
                            "flash_attention_bwd_dkdv",
                            "flash_attention_bwd_dq")),
                        ("train", trained),
                        ("train-families", trained),
                        ("train-options", trained)):
        missing = [n for n in kinds if paths[path][n] == 0]
        if missing:
            raise SystemExit(f"{path}: kernels never launched: {missing}")
    phase_cli_serve(args.seed, dev, card)
    phase_serve_parity(args.seed, dev)
    phase_serve_parity_int8(args.seed, dev, table)
    phase_beam_parity(args.seed, dev, table)
    phase_moe_parity(args.seed, dev)
    phase_mla_parity(args.seed, dev)
    phase_graph_parity(args.seed, dev, table)
    phase_graph_parity_moe(args.seed, dev, table)
    phase_train_parity(args.seed, dev)
    phase_train_parity_families(args.seed, dev)
    phase_cli_train(args.seed, dev, card)
    times = phase_timings(gen, dev, shapes, card)

    kernels = []
    for k in table:
        n = k["name"]
        kernels.append({
            "name": n, "route": k["route"], "source": k["source"],
            "replaces": k["replaces"],
            **({"also_replaces": k["also_replaces"]}
               if "also_replaces" in k else {}),
            "launches": sum(c[n] for c in paths.values()),
            "launches_by_path": {p: c[n] for p, c in paths.items()},
            "max_abs_err": errs[n], **times[n],
        })
    # MLA's instances of kernels 2 and 5-7: the mla path's launches of
    # their wrappers (every launch there is at 192 or 576).
    for n, wrapper, source, replaces in MLA_ROWS:
        kernels.append({
            "name": n, "route": "cuda", "source": source,
            "replaces": replaces, "launches": paths["mla"][wrapper],
            "launches_by_path": {"mla": paths["mla"][wrapper]},
            "max_abs_err": mla_errs[n], **mla_times[n],
        })
    # Kernels 2-4's instances at 192 with MLA training: the launches of
    # their wrappers on the MLA families' steps (every one at 192 there);
    # the forward with segments on the packed MLA step.
    mla_counts = {n: families["mla-2b"][n] + families["deepseek-v2-lite-4l"][n]
                  + mla_packed[n] for n in mla_packed}
    for n, wrapper, source, replaces in TRAIN_192_ROWS:
        launches = (mla_packed[wrapper] if n.endswith("_segments")
                    else mla_counts[wrapper])
        kernels.append({
            "name": n, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "launches_by_path": {"train-families": launches},
            "max_abs_err": train192_errs[n], **train192_times[n],
        })
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
