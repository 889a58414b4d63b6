"""Continuous batching: many requests share one fixed device batch.

Ports `shellac_tpu/inference/batching.py` (`BatchingEngine` :183,
`PagedBatchingEngine` :2439) with its admission and decode pipelines.
The engine keeps a fixed-shape slot batch on the device and multiplexes
requests onto it:

  - a free slot is filled by prefilling one request's prompt into a
    batch-1 dense mini cache (prompt lengths bucket to powers of two) and
    scattering it into the slot: a dense row (`scatter_slot`), or the
    slot's pages of the block pool through its table row. The prefill is
    one program per (bucket, greedy or sampling): it reads a fixed token
    buffer, the slot, the prompt length and the budget as device
    tensors, and the slot's sampling settings from the per-slot vectors,
    and writes the slot's first token and stop state on the device, so
    on the card it runs as a CUDA graph (`inference/graphs.py`), the
    counterpart of the JAX engine's prefill jitted per bucket (:1433):
    the bucket's first prefill runs eagerly, every later one replays.
    The prefill graphs share one memory pool;
  - a prompt longer than `prefill_chunk` prefills chunk by chunk, one
    chunk program per step under the prefill budget (`_advance_prefills`
    :1638); a continuation chunk attends through the plain attention, as
    the JAX engine pins it there (:1744, :2673). The continuation is one
    program per (pad, final or not, sampling variant), keyed as the
    reference keys `_prefix_prefill_jit` (:2597): the offset, chunk
    length and slot are device tensors staged with the tokens, so on the
    card it too is a CUDA graph in the prefill graphs' pool;
  - the paged engine's prefix cache (`prefix_cache=True`, the
    reference's :2452): a prompt whose leading full blocks are cached
    attaches them read-only and prefills only the suffix, through the
    continuation program (`_run_prefill` :2610);
  - every decode window runs `decode_ticks` single-token forwards over
    ALL slots; idle slots compute values that are discarded, and a slot
    that finishes inside the window (EOS or budget) freezes on the
    device, so shapes never change. The window reads and writes only
    tensors that keep their identity for the engine's life (the cache,
    the next tokens, the stop state, the sampling settings, the active
    mask), so on the card it runs as a CUDA graph, the counterpart of the
    JAX package's jitted `lax.scan`: one graph per (decode_ticks, greedy
    only or sampling), whose first window runs eagerly and every later
    one replays. On the CPU every program runs eagerly;
  - a request leaves its slot on EOS, a stop sequence or its max_new
    budget, and the slot is refillable at once.

Pipelines (the reference's `overlap_prefill` and `overlap_decode`):
every program's results are copied into pinned host memory on the
stream right after it is queued, and an event marks them (`HostPull`);
the host waits on that event, never on later work. With
`overlap_prefill` an admission queues its prefill and moves on; every
prefill in flight settles at the next step boundary (`_PrefillFlight`
:139), and TTFT is marked there. With `overlap_decode` the step queues
the next window before it waits for the previous one (`_DecodeWindow`
:162), so the card computes window k+1 while the host settles window k;
a window's pairs record which request owned each slot at dispatch, and
results for a slot cancelled or refilled in flight are discarded. Both
off is strict ordering: every program's results are waited for at
once. Everything runs on one stream: in-place writes, releases and
block-table writes stay ordered behind the programs in flight, and no
host-to-device copy blocks (`ops.dispatch.copy_from_host`).

Greedy output for any request is what the single-request Engine gives:
the scheduling is invisible to the math.

The host owns the cache's length bookkeeping: it knows each slot's
length (prompt + tokens written, projected past the windows in flight)
and sets the cache's `max_length` to the true maximum before each
window, so a long-running engine whose slots recycle never trips the
write guard that `forward_with_cache` keeps for a growing batch. A
released slot's device length is reset to 0, so an idle slot attends
one position.

The cache backend is dense or paged, in the compute dtype or int8
(`dense-int8`, `paged-int8`, or the legacy `kv_quant="int8"`): the
prefill quantizes into an int8 mini and scatters values and scales.

Observability (`obs/`): the engine writes its `EngineMetrics` (prefill
section and decode window seconds, host overhead, step phases, batch
occupancy, slots busy, queue depth, KV utilization) into `registry`
(the process default unless given one) once per `step()`, on the host;
a request submitted with `trace=` (an `obs.RequestTrace`) gets the JAX
engine's marks: queue at submit, prefill_start at admission,
prefill-dispatch under overlap_prefill, first_token when the prefill's
token is on the host (its settle), window-dispatch and window-settle per
window, and abort("cancelled") on cancel. Nothing is recorded inside a
captured program.

Per-request controls (`submit`): logit bias, presence and frequency
penalties over the generated tokens, per-request seeds and prompt
logprobs, applied in `_row_decode_step`'s order (:775) inside the window
and in every prefill's first token (`_sample_first` :1100). The bias and
count matrices are allocated at the first request that needs them; the
window graphs are keyed by (decode_ticks, greedy, bias, penalties,
seeds, constraints) as the reference keys its decode jit (:2026-2050),
so requests without controls keep their graph.

Constrained decoding (`submit(constraint=)`, a compiled
`constraints.TokenDFA`): each slot carries a row offset into one
resident table of DFA rows (-1 = unconstrained) and its DFA state, both
device vectors. Every tick of a window masks the adjusted logits with
the row `trans[off + state]` (disallowed tokens get NEG_INF whatever
the bias says; EOS legality is the last column) and advances the state
by the sampled token, in place; each final prefill program samples the
first token under the DFA's state-0 row and sets the slot's state from
it on the device. The table holds one copy of each distinct TokenDFA:
an admission places its DFA's rows (first fit, an upload only when the
table is not already resident) before its prefill is queued, so stream
order keeps every program in flight on the rows it was queued with.
When no gap holds a new table, the tables no slot uses are dropped, and
failing that the buffer is replaced by one of the next power of two of
rows, which drops the graphs that read the old buffer.

Beam search (`beam_search`, the reference's :2407 and :2752): the dense
caches delegate to a single-request `Engine` sharing the params; the
paged engine searches over the pool with copy-on-write block tables
(`_beam_paged_impl`), its prefill and step programs CUDA graphs kept
across calls.

Not ported yet; each raises NotImplementedError: meshes and pipeline
stages, rolling caches, preemption, and at `submit` prefill-only
requests and QoS tags.
"""

from __future__ import annotations

import functools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from shellac_tpu_torch.config import ModelConfig
from shellac_tpu_torch.inference.cache import (
    CacheBackend,
    PoolExhausted,
    kv_field_names,
    make_backend,
    resolve_backend_name,
    scatter_slot,
)
from shellac_tpu_torch.inference.constraints import TokenDFA
from shellac_tpu_torch.inference.engine import (
    Engine,
    _bucket,
    _dfa_table,
    _pull_beams,
    _upload_dfa,
    beam_expand,
    beam_filter_invalid,
    beam_first_expand,
    beam_rank,
    check_beam_constraint,
)
from shellac_tpu_torch.inference.graphs import (
    HostPull,
    StepGraph,
    call_captured,
)
from shellac_tpu_torch.models import transformer
from shellac_tpu_torch.obs import EngineMetrics, get_registry
from shellac_tpu_torch.ops.dispatch import (
    DeviceLike,
    check_on,
    copy_from_host,
    resolve_device,
)
from shellac_tpu_torch.ops.sampling import NEG_INF, sample_batched


def _unported(**opts) -> None:
    """Raise NotImplementedError for an option set to anything but its
    off value (None or False)."""
    for name, value in opts.items():
        if value is not None and value is not False:
            raise NotImplementedError(f"{name}={value!r} is not ported yet")


@dataclass
class _Request:
    rid: Any
    tokens: np.ndarray  # (S,) int32 prompt
    max_new: int
    stop: Optional[List[List[int]]] = None  # token-id stop sequences
    # Sampling settings resolved at submit (top_k >= 1; vocab = off).
    temperature: float = 0.0
    top_k: int = 1
    top_p: float = 1.0
    min_p: float = 0.0
    # EOS is banned from sampling until this many tokens are emitted.
    min_tokens: int = 0
    # Per-request controls (validated at submit): additive logit biases
    # by token id, OpenAI presence and frequency penalties over the
    # generated tokens, a seed (folded to 31 bits; None = the shared
    # stream), and whether the prompt is scored.
    logit_bias: Optional[Dict[int, float]] = None
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    seed: Optional[int] = None
    prompt_logprobs: bool = False
    # The prompt's per-token logprobs once its prefill settled (position
    # 0 reports 0.0), and on the way there each earlier chunk's scores:
    # [(HostPull of (in-chunk scores, boundary score), chunk length)].
    plp: Optional[List[float]] = None
    plp_pieces: Optional[List[Tuple[HostPull, int]]] = None
    # A compiled constraints.TokenDFA every sampled token obeys.
    constraint: Optional[Any] = None
    # Generated tokens so far; grows only, except that a stop-sequence
    # match removes the matched suffix once, at completion.
    out: List[int] = field(default_factory=list)
    # Raw-distribution logprob of each emitted token (logprobs=True).
    lps: List[float] = field(default_factory=list)
    # Per emitted token, the top-K alternatives as ([ids], [logprobs]).
    tlp: Optional[List] = None
    # Host clock (time.perf_counter): queued, admitted to a slot, first
    # token on the host.
    t_queued: float = 0.0
    t_admitted: float = 0.0
    t_first: float = 0.0
    # The request's span (obs.RequestTrace), or None when not traced.
    trace: Optional[Any] = None

    def hit_stop(self) -> Optional[int]:
        """Length of the matched stop suffix of `out`, or None."""
        for seq in self.stop or ():
            n = len(seq)
            if n and len(self.out) >= n and self.out[-n:] == seq:
                return n
        return None


def _put(t: torch.Tensor, slot: int, value) -> None:
    """t[slot] = value as a fill on the device. (Assigning a Python scalar
    to one element copies a host scalar tensor into it, and a copy from
    pageable host memory waits for every program queued before it, the
    windows in flight included.)"""
    t[slot:slot + 1].fill_(value)


class _Ctl(NamedTuple):
    """Which per-request controls a program applies: the bias matrix,
    the penalties over the count matrix, the seeded draw, the DFA
    mask and state advance."""

    bias: bool = False
    pen: bool = False
    seed: bool = False
    con: bool = False


_NO_CTL = _Ctl()


class _Program(NamedTuple):
    """A prefill program's key. `kind` "fresh" prefills from position 0
    through the mini cache (kernel 2); "chunk" continues a slot past the
    device offset through the plain attention. `final` programs sample
    the first token (a non-final chunk only writes the cache); `plp`
    also returns the prompt's logprobs."""

    kind: str
    pad: int
    final: bool = True
    greedy: bool = True
    ctl: _Ctl = _NO_CTL
    plp: bool = False


def _plp_within(logits, tokens):
    """Each token's logprob given its in-row predecessor (position t
    scores from logits row t-1; position 0 reports 0.0): the reference's
    `_plp_within` (:657), shared by whole prompts and chunks."""
    lps = torch.log_softmax(logits[0, :-1].float(), dim=-1)
    tok = torch.gather(lps, 1, tokens[0, 1:, None])[:, 0]
    return torch.cat([tok.new_zeros((1,)), tok])


class _PrefillFlight:
    """Host-side record of ONE queued, not yet settled prefill (or final
    chunk). `pull` carries its packed results (first token, its raw
    logprob, the top-K alternatives) to the host. `req` is the request
    that owned the slot at dispatch: the settle discards results for a
    slot cancelled or refilled in flight (identity check, as for decode
    windows)."""

    __slots__ = ("slot", "req", "pull")

    def __init__(self, slot: int, req: _Request, pull: HostPull):
        self.slot = slot
        self.req = req
        self.pull = pull


class _DecodeWindow:
    """Host-side record of ONE queued, not yet synced decode window.
    `pairs` records which request owned each active slot at dispatch;
    `ticks` is the window's decode_ticks at dispatch (the autotuner may
    retune between windows); `pull` carries its packed results."""

    __slots__ = ("pairs", "ticks", "pull", "t_dispatch")

    def __init__(self, pairs, ticks: int, pull: HostPull):
        self.pairs = pairs  # [(slot, _Request)] active at dispatch
        self.ticks = ticks
        self.pull = pull
        self.t_dispatch = time.perf_counter()


@dataclass
class _PagedBeam:
    """One paged beam-search key's fixed buffers: the staged inputs, the
    beams' tables and lengths over the engine's pool, and the search
    state the step program updates in place."""

    inp: torch.Tensor  # (_BEAM_HEAD + max_len,) int64 header + tokens
    tables: torch.Tensor  # (K, max_blocks) int32
    gen: torch.Tensor  # (max_blocks, K) int64 owned blocks per beam
    lengths: torch.Tensor  # (K,) int32
    cur: torch.Tensor  # (K,) int64
    scores: torch.Tensor  # (K,) fp32
    finished: torch.Tensor  # (K,) bool
    out: torch.Tensor  # (K, max_len) int64
    lens: torch.Tensor  # (K,) int32
    cstate: torch.Tensor  # (K,) int64
    at: torch.Tensor  # (1,) int64 the step index
    ctrans: Optional[torch.Tensor]  # (rows, V + 1) int32 DFA table
    dfa: Any = None
    prefills: Dict[Tuple[int, bool], Any] = field(default_factory=dict)
    step: Any = None


class BatchingEngine:
    """Fixed-slot continuous batching over one model on one device (the
    card by default).

    Storage is delegated to a cache backend (`inference/cache`):
    `cache_backend` takes a registry name or a constructed CacheBackend.
    """

    # Backend families this class drives; the paged subclass overrides.
    _backend_family: Tuple[str, ...] = ("dense", "dense-int8")
    # Extra per-slot residency past prompt + max_new + 1 a window may
    # write.
    _footprint_slack = 0

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        *,
        n_slots: int = 8,
        max_len: Optional[int] = None,
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        min_p: Optional[float] = None,
        eos_id: Optional[int] = None,
        seed: int = 0,
        attn_impl: str = "auto",
        decode_ticks="auto",
        overlap_decode: bool = False,
        overlap_prefill: bool = False,
        max_prefills_per_step: Optional[int] = None,
        prefill_chunk=None,
        logprobs: bool = False,
        top_logprobs: int = 0,
        mesh=None,
        kv_quant: Optional[str] = None,
        rolling_window: bool = False,
        pp_pipeline: bool = False,
        cache_backend=None,
        registry=None,
        device: DeviceLike = None,
    ):
        _unported(mesh=mesh, rolling_window=rolling_window,
                  pp_pipeline=pp_pipeline)
        top_logprobs = int(top_logprobs or 0)
        if top_logprobs < 0 or top_logprobs > 32:
            raise ValueError(
                f"top_logprobs={top_logprobs}: must be in [0, 32]"
            )
        if top_logprobs and not logprobs:
            raise ValueError("top_logprobs needs logprobs=True")
        # decode_ticks "auto" runs as 1 until the serving entry points'
        # autotuner (inference/autotune.py) writes the winner back.
        self.decode_ticks_requested = decode_ticks
        if decode_ticks == "auto":
            decode_ticks = 1
        elif isinstance(decode_ticks, str):
            raise ValueError(
                f"decode_ticks={decode_ticks!r}: need an int >= 1 or 'auto'"
            )
        if decode_ticks < 1:
            raise ValueError(f"decode_ticks must be >= 1, got {decode_ticks}")
        if max_prefills_per_step is not None and max_prefills_per_step < 1:
            raise ValueError("max_prefills_per_step must be >= 1")
        # prefill_chunk "auto" runs as None (whole prompts) until tuned.
        self.prefill_chunk_requested = prefill_chunk
        if prefill_chunk == "auto":
            prefill_chunk = None
        elif isinstance(prefill_chunk, str):
            raise ValueError(
                f"prefill_chunk={prefill_chunk!r}: need an int >= 1, "
                "None, or 'auto'"
            )
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        transformer.check_supported(cfg)
        self.device = resolve_device(device)
        check_on(self.device, embed=params["embed"])
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len or cfg.max_seq_len
        self.eos_id = eos_id
        self.attn_impl = attn_impl
        self.decode_ticks = decode_ticks
        self.max_prefills_per_step = max_prefills_per_step
        self.prefill_chunk = prefill_chunk
        self.overlap_decode = bool(overlap_decode)
        self.overlap_prefill = bool(overlap_prefill)
        self.logprobs = logprobs
        self.top_logprobs = top_logprobs

        if isinstance(cache_backend, CacheBackend):
            if kv_quant is not None and kv_quant != cache_backend.kv_quant:
                raise ValueError(
                    f"kv_quant={kv_quant!r} conflicts with the "
                    f"{cache_backend.name!r} backend instance"
                )
            if (cache_backend.n_slots != n_slots
                    or cache_backend.max_len != self.max_len):
                raise ValueError(
                    f"{cache_backend.name!r} backend instance geometry "
                    f"(n_slots={cache_backend.n_slots}, "
                    f"max_len={cache_backend.max_len}) does not match the "
                    f"engine (n_slots={n_slots}, max_len={self.max_len})"
                )
            backend = cache_backend
        else:
            backend = make_backend(
                resolve_backend_name(cache_backend, kv_quant=kv_quant), cfg,
                n_slots, self.max_len)
        if backend.name not in self._backend_family:
            raise ValueError(
                f"{type(self).__name__} drives cache backends "
                f"{self._backend_family}, not {backend.name!r}; "
                "inference.cache.engine_class names the engine for a backend"
            )
        backend.bind(self)
        self.cache_backend = backend
        self.kv_quant = backend.kv_quant

        self._defaults = {
            "temperature": float(temperature),
            # top_k resolves once, here: None (disabled) = full vocab.
            "top_k": int(top_k) if top_k is not None else cfg.vocab_size,
            "top_p": float(top_p) if top_p is not None else 1.0,
            "min_p": float(min_p) if min_p is not None else 0.0,
        }
        self._validate_sampling(self._defaults, "engine defaults")
        dev, n = self.device, n_slots

        def full(value, dtype):
            return torch.full((n,), value, dtype=dtype, device=dev)

        # Per-slot sampling settings the decode window samples with, so
        # one tick serves greedy and sampled requests side by side.
        self._stemp = full(self._defaults["temperature"], torch.float32)
        self._stopk = full(self._defaults["top_k"], torch.int64)
        self._stopp = full(self._defaults["top_p"], torch.float32)
        self._sminp = full(self._defaults["min_p"], torch.float32)
        # Device-side stop state threaded through the window: remaining
        # min_tokens (EOS ban), remaining max_new budget, a sticky done
        # flag; and each slot's next input token.
        self._smin = full(0, torch.int32)
        self._srem = full(0, torch.int32)
        self._sdone = full(False, torch.bool)
        self._cur = full(0, torch.int64)
        # The slots a window advances, and the host's copy of it: each
        # window rewrites (by fills) the slots that changed.
        self._active = full(False, torch.bool)
        self._active_host = [False] * n
        # Per-slot controls (the reference's :451-482): the (n_slots, V)
        # bias and fp32 count matrices, allocated at the first request
        # that needs them, and the host's record of which slots use
        # them; presence and frequency coefficients; each slot's seed
        # (-1 = the shared stream) and its generated-token count at a
        # window's start (staged per seeded window).
        self._sbias: Optional[torch.Tensor] = None
        self._slot_bias: List[Optional[Dict[int, float]]] = [None] * n
        self._scounts: Optional[torch.Tensor] = None
        self._slot_pen = [False] * n
        self._spres = full(0.0, torch.float32)
        self._sfreq = full(0.0, torch.float32)
        self._sseed = full(-1, torch.int64)
        self._sgen0 = full(0, torch.int64)
        self._gen = torch.Generator(device=dev)
        self._gen.manual_seed(int(seed))
        # Constrained decoding (the reference's :483-496): each slot's
        # TokenDFA (host), its row offset into the resident table (-1 =
        # unconstrained) and its DFA state; the (rows, V + 1) int32
        # table, allocated at the first constrained request, and the
        # tables resident in it: id(dfa) -> (dfa, row offset), kept
        # after their last slot leaves until their rows are needed.
        self._slot_dfa: List[Optional[Any]] = [None] * n
        self._coff = full(-1, torch.int64)
        self._cstate = full(0, torch.int64)
        self._ctrans: Optional[torch.Tensor] = None
        self._cres: Dict[int, Tuple[Any, int]] = {}
        # Program runners (a StepGraph on the card): decode windows by
        # (decode_ticks, greedy_only, bias, penalties, seeds,
        # constraints), prefills by _Program.
        self._window_graphs: Dict[Tuple[int, bool, bool, bool, bool, bool],
                                  Any] = {}
        self._prefill_graphs: Dict[_Program, Any] = {}
        # The memory pool every prefill graph shares (the card only).
        self._prefill_pool = None
        # The prefill programs' fixed inputs, built at the first
        # prefill: (slot, chunk length, max_new, offset, the next
        # chunk's first token, padded tokens...) and one max_len mini
        # cache whose prefix each bucket writes.
        self._pf_in: Optional[torch.Tensor] = None
        self._pf_mini = None
        self._pf_zero: Optional[torch.Tensor] = None
        # Queued, un-synced decode windows, oldest first (at most 2 deep
        # by step()'s structure), and queued, unsettled prefills.
        self._windows: Deque[_DecodeWindow] = deque()
        self._pflights: List[_PrefillFlight] = []
        # Chunked prefills under way: slot -> prompt tokens written.
        self._prefilling: Dict[int, int] = {}
        # Test and bench seams (inference.autotune.SimulatedHostLatency):
        # None, or objects with on_dispatch(window)/before_sync(window)
        # and on_prefill_dispatch(flight)/before_prefill_sync(flights).
        self._window_hooks = None
        self._prefill_hooks = None
        # beam_search's state: the dense caches' single-request Engine,
        # built at the first search; the paged search's buffers and
        # programs per (K, eos_id, constrained) key.
        self._beam_delegate = None
        self._beams: Dict[Tuple, Any] = {}

        self._cache = backend.init_cache(dev)
        # Host copy of each slot's cache length (positions written),
        # behind the device by the windows in flight.
        self._host_len: List[int] = [0] * n_slots
        self._queue: Deque[_Request] = deque()
        self._slots: List[Optional[_Request]] = [None] * n_slots
        self.finished_logprobs: Dict[Any, List[float]] = {}
        self.finished_top_logprobs: Dict[Any, List] = {}
        # prompt_logprobs=True requests: rid -> the prompt's per-token
        # logprobs (position 0 has no predictor and reports 0.0).
        self.finished_prompt_logprobs: Dict[Any, List[float]] = {}
        # rid -> (queued, admitted, first token, finished), host clock.
        self.finished_timings: Dict[Any, Tuple[float, ...]] = {}
        self.stats: Dict[str, int] = {
            "requests_completed": 0,
            "tokens_generated": 0,
            "engine_steps": 0,
            "prefills": 0,
            "prefill_chunks": 0,
            "requests_cancelled": 0,
            # The live pipeline configuration, mirrored at /metrics:
            # decode_ticks (the autotuner rewrites it), the window
            # pipeline depth (2 overlapped, 1 strict), whether prefills
            # overlap, the live chunk size (0 = whole prompts).
            "decode_ticks": decode_ticks,
            "overlap_depth": 2 if self.overlap_decode else 1,
            "overlap_prefill": 1 if self.overlap_prefill else 0,
            "prefill_chunk": prefill_chunk or 0,
            # Admissions put back because the backend had no room.
            "pool_exhausted": 0,
            "decode_windows": 0,
            # Window variants captured as CUDA graphs (the card only).
            "decode_graphs": 0,
        }
        self.stats.update(backend.initial_stats())
        # How decode_ticks and prefill_chunk were chosen: "fixed", or
        # "auto" until the autotuner rewrites it to "auto-tuned".
        self.decode_ticks_source = (
            "auto" if self.decode_ticks_requested == "auto" else "fixed")
        self.prefill_chunk_source = (
            "auto" if self.prefill_chunk_requested == "auto" else "fixed")
        # Engine instruments over the shared registry, written once per
        # step on the host (never inside a captured program).
        self.obs = EngineMetrics(
            registry if registry is not None else get_registry())
        # Per-step phase seconds (obs.STEP_PHASES) and the time blocked
        # in window syncs, reset by each step().
        self._phase_s: Dict[str, float] = {}
        self._sync_block_s = 0.0

    # ---- sampling ----------------------------------------------------

    @staticmethod
    def _validate_sampling(d: Dict[str, Any], label) -> None:
        if d["temperature"] < 0:
            raise ValueError(f"{label}: temperature must be >= 0")
        if d["top_k"] < 1:
            raise ValueError(f"{label}: top_k must be >= 1 (or None)")
        if not 0 < d["top_p"] <= 1:
            raise ValueError(f"{label}: top_p must be in (0, 1]")
        if not 0 <= d["min_p"] < 1:
            raise ValueError(f"{label}: min_p must be in [0, 1)")

    def _adjust_logits(self, logits, min_rem, bias=None):
        """Per-row logit biases and the min_tokens EOS ban on a (B, V)
        fp32 logit block; sampling consumes the result while logprobs
        keep the raw distribution."""
        x = logits.float()
        if bias is not None:
            x = x + bias
        if self.eos_id is None:
            return x
        if bias is None:
            x = x.clone()
        x[:, self.eos_id] = torch.where(min_rem > 0, NEG_INF,
                                        x[:, self.eos_id])
        return x

    @staticmethod
    def _request_ctl(req: _Request) -> _Ctl:
        """The controls `req`'s prefill applies (a greedy request's seed
        draws nothing)."""
        return _Ctl(bias=bool(req.logit_bias),
                    pen=(req.presence_penalty != 0.0
                         or req.frequency_penalty != 0.0),
                    seed=req.seed is not None and req.temperature > 0.0,
                    con=req.constraint is not None)

    def _mask_constrained(self, adj, row, con=None):
        """Mask (B, V) adjusted logits with (B, V + 1) DFA rows: a token
        the row disallows gets NEG_INF whatever the bias says, and EOS
        legality comes from the last column (the reference's :799-812).
        `con` (B,) picks the constrained rows; None means all."""
        allowed = row[:, :-1] >= 0
        if self.eos_id is not None:
            allowed[:, self.eos_id] = row[:, -1] >= 0
        bad = ~allowed if con is None else con[:, None] & ~allowed
        return adj.masked_fill(bad, NEG_INF)

    def _dfa_next(self, row, tok):
        """The DFA states after `tok` (B,) from (B, V + 1) rows; EOS
        reads the last column, and a disallowed token (-1) gives 0, as
        the reference clamps it (:826-837)."""
        col = tok
        if self.eos_id is not None:
            col = torch.where(tok == self.eos_id, row.shape[1] - 1, tok)
        return row.gather(1, col[:, None])[:, 0].to(torch.int64).clamp_min(0)

    def _first_token(self, last, slot, max_new, greedy: bool,
                     ctl: _Ctl = _NO_CTL):
        """A prefill's exit, on the device: sample the first output token
        from the last prompt position's (1, V) logits, adjusted under the
        slot's settings (bias, EOS ban; a seeded draw is its stream's
        gen_idx 0), and arm the slot's decode state (its next token, its
        remaining budget, done cleared, one unit of the EOS ban used; a
        penalized slot counts the token). `slot` and `max_new` are (1,)
        device tensors. Returns the packed (2 + 2K,) fp64 results: the
        token, its raw logprob, then the top-K logprobs and ids."""
        min_rem = self._smin.index_select(0, slot)
        bias = self._sbias.index_select(0, slot) if ctl.bias else None
        adj = self._adjust_logits(last, min_rem, bias)
        if ctl.con:
            # The DFA's state-0 row, added last (`_sample_first`
            # :1111): the first token obeys the grammar too.
            row = self._ctrans.index_select(
                0, self._coff.index_select(0, slot))
            adj = self._mask_constrained(adj, row)
        if greedy:
            first = torch.argmax(adj, dim=-1)
        else:
            first = sample_batched(
                self._gen, adj, self._stemp.index_select(0, slot),
                self._stopk.index_select(0, slot),
                self._stopp.index_select(0, slot),
                self._sminp.index_select(0, slot),
                seed=self._sseed.index_select(0, slot) if ctl.seed else None,
                gen_idx=torch.zeros_like(slot) if ctl.seed else None)
        if ctl.pen:
            self._scounts.index_put_(
                (slot, first), torch.ones((1,), dtype=torch.float32,
                                          device=first.device),
                accumulate=True)
        if ctl.con:
            # The slot's state past the first token, set here on the
            # device (the reference sets it at the settle, :1593-1601).
            self._cstate.index_copy_(0, slot, self._dfa_next(row, first))
        lsm = torch.log_softmax(last.float(), dim=-1)
        parts = [first.double(), torch.gather(lsm, 1, first[:, None])[:, 0]
                 .double()]
        if self.top_logprobs:
            tlv, tli = torch.topk(lsm, self.top_logprobs, dim=-1)
            parts += [tlv[0].double(), tli[0].double()]
        self._cur.index_copy_(0, slot, first.to(self._cur.dtype))
        self._srem.index_copy_(0, slot, (max_new - 1).to(torch.int32))
        self._sdone.index_fill_(0, slot, False)
        self._smin.index_copy_(0, slot, (min_rem - 1).clamp_min(0))
        return torch.cat(parts)

    # ---- admission ---------------------------------------------------

    def submit(self, rid, tokens, max_new: int, stop=None, *,
               temperature=None, top_k=None, top_p=None, min_p=None,
               min_tokens=None, logit_bias=None, presence_penalty=None,
               frequency_penalty=None, prompt_logprobs=False, seed=None,
               constraint=None, trace=None, prefill_only: bool = False,
               tenant=None, qos_class=None, qos_weight=None) -> None:
        """Queue a request. `stop`: token-id sequences; generation ends
        when the output ends with one, and the match is removed from the
        returned tokens. temperature/top_k/top_p/min_p override the
        engine defaults for this request only. `logit_bias` ({token id:
        additive bias}), `presence_penalty` and `frequency_penalty` (over
        the generated tokens), `seed` (a deterministic stream of its
        own) and `prompt_logprobs` (kept in finished_prompt_logprobs)
        are validated as the reference's (:1167-1204). `constraint` (a
        compiled constraints.TokenDFA over vocab + 1 columns, with the
        engine's eos_id) masks every sampled token (:1205-1240). `trace`
        (an obs.RequestTrace) receives the request's lifecycle marks."""
        _unported(prefill_only=prefill_only, tenant=tenant,
                  qos_class=qos_class, qos_weight=qos_weight)
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        if tokens.size == 0:
            raise ValueError(f"request {rid!r}: empty prompt")
        if max_new < 1:
            raise ValueError(f"request {rid!r}: max_new must be >= 1")
        if tokens.size + max_new + 1 > self.max_len:
            raise ValueError(
                f"request {rid!r}: prompt {tokens.size} + max_new {max_new} "
                f"exceeds max_len {self.max_len}"
            )
        if stop is not None:
            stop = [list(map(int, s)) for s in stop]
            if any(len(s) == 0 for s in stop):
                raise ValueError(f"request {rid!r}: empty stop sequence")
        d = self._defaults
        samp = {
            "temperature": float(
                temperature if temperature is not None else d["temperature"]
            ),
            "top_k": int(top_k) if top_k is not None else d["top_k"],
            "top_p": float(top_p) if top_p is not None else d["top_p"],
            "min_p": float(min_p) if min_p is not None else d["min_p"],
        }
        self._validate_sampling(samp, f"request {rid!r}")
        min_tokens = int(min_tokens) if min_tokens is not None else 0
        if min_tokens < 0:
            raise ValueError(f"request {rid!r}: min_tokens must be >= 0")
        if min_tokens > 0 and self.eos_id is None:
            raise ValueError(
                f"request {rid!r}: min_tokens needs the engine's eos_id"
            )
        if logit_bias is not None:
            try:
                logit_bias = {int(k): float(v)
                              for k, v in dict(logit_bias).items()}
            except (TypeError, ValueError) as e:
                raise ValueError(f"request {rid!r}: bad logit_bias: {e}")
            oob = [k for k in logit_bias if not 0 <= k < self.cfg.vocab_size]
            if oob:
                raise ValueError(
                    f"request {rid!r}: logit_bias token ids {oob} outside "
                    f"vocab [0, {self.cfg.vocab_size})"
                )
        if prompt_logprobs and getattr(self, "prefix_cache", False):
            raise ValueError(
                f"request {rid!r}: prompt_logprobs does not compose "
                "with the prefix cache (a cache hit skips exactly the "
                "forward passes that would score the prefix); use a "
                "non-prefix-cached engine for scoring"
            )
        pres = float(presence_penalty) if presence_penalty is not None \
            else 0.0
        freq = float(frequency_penalty) if frequency_penalty is not None \
            else 0.0
        for nm, v in (("presence_penalty", pres),
                      ("frequency_penalty", freq)):
            if not np.isfinite(v):
                raise ValueError(f"request {rid!r}: {nm} must be finite")
        if seed is not None:
            seed = int(seed)
            if seed < 0:
                raise ValueError(
                    f"request {rid!r}: seed must be >= 0 (negative is "
                    "the unseeded sentinel)"
                )
            # OpenAI clients send 63-bit seeds; fold them to 31 bits.
            seed &= 0x7FFFFFFF
        if constraint is not None:
            if not isinstance(constraint, TokenDFA):
                raise ValueError(
                    f"request {rid!r}: constraint must be a compiled "
                    "constraints.TokenDFA (the server compiles specs; "
                    "library users call compile_token_dfa)"
                )
            if constraint.trans.shape[1] != self.cfg.vocab_size + 1:
                raise ValueError(
                    f"request {rid!r}: constraint table covers "
                    f"{constraint.trans.shape[1] - 1} tokens, model "
                    f"vocab is {self.cfg.vocab_size}"
                )
            if self.eos_id is None or constraint.eos_id != self.eos_id:
                raise ValueError(
                    f"request {rid!r}: constraint eos_id "
                    f"{constraint.eos_id} must equal the engine's "
                    f"eos_id {self.eos_id} (termination and EOS "
                    "masking must agree)"
                )
            if min_tokens > 0:
                raise ValueError(
                    f"request {rid!r}: min_tokens does not compose "
                    "with constraint (the EOS ban can contradict a "
                    "state where only EOS is legal)"
                )
        self._queue.append(_Request(
            rid, tokens, max_new, stop=stop, min_tokens=min_tokens,
            logit_bias=logit_bias, presence_penalty=pres,
            frequency_penalty=freq, seed=seed,
            prompt_logprobs=bool(prompt_logprobs), constraint=constraint,
            t_queued=time.perf_counter(), trace=trace, **samp,
        ))
        if trace is not None:
            # The request entered the admission queue (queue wait ends
            # at the span's prefill_start).
            trace.record("queue", src="engine", rid=rid,
                         queue_depth=len(self._queue))

    def _slot_footprint(self, req: _Request) -> int:
        """Worst-case token residency of `req`: prompt + budget + 1 plus
        the engine's window slack. The backend reserves it at admission."""
        return req.tokens.size + req.max_new + 1 + self._footprint_slack

    def _release_slot(self, slot: int) -> None:
        """A request left `slot`: the backend releases its storage, the
        slot's device length returns to 0 and its bias row, counts and
        DFA offset and state are cleared (in stream order, behind any
        program in flight), so a later request on the slot inherits
        nothing. Its DFA's table stays resident for a later request."""
        self.cache_backend.release_slot(slot)
        _put(self._cache.lengths, slot, 0)
        self._host_len[slot] = 0
        if self._slot_bias[slot] is not None:
            self._sbias[slot].zero_()
            self._slot_bias[slot] = None
        if self._slot_pen[slot]:
            _put(self._spres, slot, 0.0)
            _put(self._sfreq, slot, 0.0)
            self._scounts[slot].zero_()
            self._slot_pen[slot] = False
        if self._slot_dfa[slot] is not None:
            self._slot_dfa[slot] = None
            _put(self._coff, slot, -1)
            _put(self._cstate, slot, 0)

    def _zeros_v(self) -> torch.Tensor:
        return torch.zeros((self.n_slots, self.cfg.vocab_size),
                           dtype=torch.float32, device=self.device)

    def _set_slot_sampling(self, slot: int, req: _Request) -> None:
        """Write the request's settings into the per-slot vectors the
        programs sample with: fills, and one pinned copy for a bias row
        (`_set_slot_sampling` :1353)."""
        _put(self._stemp, slot, req.temperature)
        _put(self._stopk, slot, req.top_k)
        _put(self._stopp, slot, req.top_p)
        _put(self._sminp, slot, req.min_p)
        _put(self._smin, slot, req.min_tokens)
        _put(self._sseed, slot, req.seed if req.seed is not None else -1)
        bias = req.logit_bias or None
        if bias != self._slot_bias[slot]:
            if self._sbias is None:
                self._sbias = self._zeros_v()
            if bias is None:
                self._sbias[slot].zero_()
            else:
                row = np.zeros((self.cfg.vocab_size,), np.float32)
                for k, v in bias.items():
                    row[k] = v
                copy_from_host(self._sbias[slot], row)
            self._slot_bias[slot] = bias
        penalized = self._request_ctl(req).pen
        if penalized or self._slot_pen[slot]:
            if self._scounts is None:
                self._scounts = self._zeros_v()
            _put(self._spres, slot, req.presence_penalty)
            _put(self._sfreq, slot, req.frequency_penalty)
            self._scounts[slot].zero_()
        self._slot_pen[slot] = penalized
        if req.constraint is not None:
            # Placed now, before the prefill that reads its state-0 row
            # is queued (the reference restacks lazily before the next
            # window, :1387, and masks the first token from a host row).
            _put(self._coff, slot, self._place_constraint(req.constraint))
            _put(self._cstate, slot, 0)
            self._slot_dfa[slot] = req.constraint

    # ---- the constraint table ----------------------------------------

    def _fit_rows(self, rows: int) -> Optional[int]:
        """The lowest row offset where `rows` rows fit between the
        resident tables, or None."""
        if self._ctrans is None:
            return None
        at = 0
        for off, end in sorted((o, o + d.trans.shape[0])
                               for d, o in self._cres.values()):
            if off - at >= rows:
                return at
            at = max(at, end)
        return at if self._ctrans.shape[0] - at >= rows else None

    def _place_constraint(self, dfa) -> int:
        """The row offset of `dfa`'s table in the resident table. A
        table not resident is uploaded (one pinned copy, in stream
        order) into the first gap that holds it; without one, the
        tables no slot uses are dropped, and failing that the table
        grows."""
        hit = self._cres.get(id(dfa))
        if hit is not None:
            return hit[1]
        rows = dfa.trans.shape[0]
        off = self._fit_rows(rows)
        if off is None:
            live = {id(d) for d in self._slot_dfa if d is not None}
            self._cres = {k: v for k, v in self._cres.items() if k in live}
            off = self._fit_rows(rows)
        if off is None:
            self._grow_table(rows)
            off = self._fit_rows(rows)
        copy_from_host(self._ctrans[off:off + rows], dfa.trans)
        self._cres[id(dfa)] = (dfa, off)
        return off

    def _grow_table(self, rows: int) -> None:
        """Replace the table by one of the next power of two rows (at
        least 64) that holds the live tables, packed from row 0 (device
        copies), and `rows` rows more. The programs in flight
        land first, and every graph that captured the old table is
        dropped: a replay reads the storage it captured."""
        for w in self._windows:
            w.pull.get()
        for fl in self._pflights:
            fl.pull.get()
        need = rows + sum(d.trans.shape[0] for d, _ in self._cres.values())
        new = torch.full((_bucket(need, 64), self.cfg.vocab_size + 1), -1,
                         dtype=torch.int32, device=self.device)
        moved, at = {}, 0
        for key, (d, off) in self._cres.items():
            n = d.trans.shape[0]
            new[at:at + n].copy_(self._ctrans[off:off + n])
            moved[key] = (d, at)
            at += n
        self._ctrans, self._cres = new, moved
        copy_from_host(self._coff, [
            moved[id(d)][1] if d is not None else -1
            for d in self._slot_dfa])
        self._window_graphs = {k: g for k, g in self._window_graphs.items()
                               if not k[5]}
        self._prefill_graphs = {k: g for k, g in self._prefill_graphs.items()
                                if not k.ctl.con}

    def _add_phase(self, phase: str, seconds: float) -> None:
        self._phase_s[phase] = self._phase_s.get(phase, 0.0) + seconds

    def _graph(self, fn, generator, pool=None):
        """The runner of a program `fn`: a CUDA graph on the card."""
        return StepGraph(fn, self.device, generator, pool)

    # The prefill programs' staged header: (slot, chunk length, max_new,
    # offset, the next chunk's first token), then the padded tokens.
    _HEAD = 5

    def _prefill_inputs(self):
        """The prefill programs' fixed inputs, built once: an int64
        buffer (the header, then max_len padded token ids), a max_len
        mini cache of the backend's kind whose first `pad` positions a
        fresh program writes, and its zero lengths."""
        if self._pf_in is None:
            self._pf_in = torch.zeros((self._HEAD + self.max_len,),
                                      dtype=torch.int64, device=self.device)
            self._pf_mini = self.cache_backend.init_mini(self.max_len,
                                                         self.device)
            self._pf_zero = torch.zeros((1,), dtype=torch.int32,
                                        device=self.device)
        return self._pf_in

    def _stage(self, slot: int, req: _Request, off: int, s: int,
               pad: int) -> None:
        """Stage one prefill's header and its `s` tokens at `off` of the
        prompt, padded to `pad`, in one pinned copy."""
        end = off + s
        staged = np.zeros((self._HEAD + pad,), np.int64)
        staged[:self._HEAD] = (slot, s, req.max_new, off,
                               req.tokens[end] if end < req.tokens.size
                               else 0)
        staged[self._HEAD:self._HEAD + s] = req.tokens[off:end]
        copy_from_host(self._prefill_inputs()[:self._HEAD + pad], staged)

    def _program(self, key: _Program):
        """Run the prefill program `key` over the staged inputs. Reads
        only the fixed inputs, so on the card it is captured once per
        key and replayed."""
        args = self._pf_in
        slot, s, max_new, off, nxt = (args[i:i + 1] for i in range(5))
        tokens = args[self._HEAD:self._HEAD + key.pad][None]
        if key.kind == "fresh":
            logits = self._fresh_forward(key.pad, tokens, slot, s)
        else:
            logits = self._chunk_forward(key.pad, tokens, slot, s, off)
        parts = []
        if key.final:
            # The last real position's logits, gathered by the device
            # length.
            last = logits[0].index_select(0, s - 1)
            parts.append(self._first_token(last, slot, max_new, key.greedy,
                                           key.ctl))
        if key.plp:
            parts.append(_plp_within(logits, tokens).double())
            if not key.final:
                # The next chunk's first token, scored from this chunk's
                # last position (stitched across chunks at the settle).
                lsm = torch.log_softmax(
                    logits[0].index_select(0, s - 1).float(), dim=-1)
                parts.append(lsm[0].index_select(0, nxt).double())
        return torch.cat(parts) if parts else None

    def _fresh_forward(self, pad: int, tokens, slot, s):
        """The padded prompt through a fresh view of the mini cache
        (kernel 2), scattered into the slot with length `s`."""
        mini = self._pf_mini
        view = mini.replace(
            **{n: getattr(mini, n)[:, :, :, :pad]
               for n in kv_field_names(self.kv_quant)},
            lengths=self._pf_zero, max_length=0)
        logits, _ = transformer.forward_with_cache(
            self.cfg, self.params, tokens, view, fresh_cache=True,
            attn_impl=self.attn_impl,
        )
        self._scatter_prefill(view.replace(lengths=s.to(torch.int32)), slot)
        return logits

    def _scatter_prefill(self, mini, slot) -> None:
        """Write a prefilled mini into the slot's dense row (`slot` a
        (1,) device tensor)."""
        scatter_slot(self._cache, mini, slot)

    def _chunk_forward(self, pad: int, tokens, slot, s, off):
        """Continue the slot's dense row past `off` resident positions
        (device tensors throughout): the row is copied into the mini
        cache, the chunk attends it through the plain attention, as the
        JAX engine pins it (:1744), and the row is written back. The
        view's host max_length is fixed per pad; the host checked
        off + pad <= max_len."""
        mini = self._pf_mini
        names = kv_field_names(self.kv_quant)
        for n in names:
            torch.index_select(getattr(self._cache, n), 1, slot,
                               out=getattr(mini, n))
        view = mini.replace(lengths=off.to(torch.int32),
                            max_length=self.max_len - pad)
        logits, _ = transformer.forward_with_cache(
            self.cfg, self.params, tokens, view, attn_impl="ref",
        )
        for n in names:
            getattr(self._cache, n).index_copy_(1, slot, getattr(mini, n))
        self._cache.lengths.index_copy_(0, slot, (off + s).to(torch.int32))
        return logits

    def _prefill_replay(self, key: _Program):
        """One prefill program through its runner (a graph replay on the
        card after the key's first, eager run)."""
        runner = self._prefill_graphs.get(key)
        if runner is None:
            if self.device.type == "cuda" and self._prefill_pool is None:
                self._prefill_pool = torch.cuda.graph_pool_handle()
            runner = self._prefill_graphs[key] = self._graph(
                functools.partial(self._program, key), self._gen,
                self._prefill_pool)
        return runner()

    def _final_key(self, kind: str, pad: int, req: _Request) -> _Program:
        return _Program(kind, pad, True, req.temperature == 0.0,
                        self._request_ctl(req), req.prompt_logprobs)

    def _run_prefill(self, slot: int, req: _Request) -> HostPull:
        """Stage the request's prompt, slot and budget (one pinned copy),
        queue its bucket's prefill, and start its results' copy to the
        host. No host sync."""
        s = req.tokens.size
        # Cap the bucket at max_len: a larger pad would index past the
        # slot's row or its block table.
        pad = min(_bucket(s), self.max_len)
        self._stage(slot, req, 0, s, pad)
        return HostPull(self._prefill_replay(self._final_key("fresh", pad,
                                                             req)))

    def _fill_slots(self, budget: Optional[int] = None) -> None:
        done = 0
        for i in range(self.n_slots):
            if self._slots[i] is not None or not self._queue:
                continue
            if budget is not None and done >= budget:
                break
            done += 1
            req = self._queue.popleft()
            try:
                self.cache_backend.prepare_slot(i, req,
                                                self._slot_footprint(req))
            except PoolExhausted:
                # No room: the request waits at the head of the queue and
                # retries after a slot frees its storage.
                self._queue.appendleft(req)
                self.stats["pool_exhausted"] += 1
                break
            req.t_admitted = time.perf_counter()
            if req.trace is not None:
                # Queue wait ends here (after prepare_slot: a pool miss
                # requeues the request, so its wait goes on).
                req.trace.prefill_start()
            self._set_slot_sampling(i, req)
            off = self.cache_backend.prefill_offset(i)
            if off:
                # A prefix hit: the slot's device length starts at the
                # matched prefix, so a window that runs before its
                # prefill writes its idle position past the shared
                # blocks, into the slot's own.
                _put(self._cache.lengths, i, off)
            if (self.prefill_chunk is not None
                    and req.tokens.size - off > self.prefill_chunk):
                # A long prompt: admitted now, prefilled chunk by chunk
                # in step() (the slot stays out of decode until done).
                self._slots[i] = req
                self._prefilling[i] = off
                continue
            t_pf = time.perf_counter()
            self._dispatch_prefill(i, req, self._run_prefill(i, req))
            # The dispatch, apart from the admission bookkeeping around
            # it (the settle times itself into prefill_settle).
            self._add_phase("prefill_dispatch", time.perf_counter() - t_pf)
            if not self.overlap_prefill:
                self._settle_prefills()

    def _dispatch_prefill(self, slot: int, req: _Request,
                          pull: HostPull) -> None:
        """A prefill (or final chunk) was queued for `req`: record it in
        flight. The slot is occupied from here, but prefill-pending:
        `_active_rows` keeps it out of decode windows until it settles."""
        self._slots[slot] = req
        self.stats["prefills"] += 1
        fl = _PrefillFlight(slot, req, pull)
        self._pflights.append(fl)
        if self._prefill_hooks is not None:
            self._prefill_hooks.on_prefill_dispatch(fl)
        if self.overlap_prefill and req.trace is not None:
            # The dispatch half of the prefill pipeline (the settle lands
            # as the span's first_token).
            req.trace.record("prefill-dispatch", src="engine",
                             rid=req.rid, slot=slot,
                             depth=len(self._pflights))

    def _pending_prefill_slots(self):
        """Slots whose prefill is queued but not settled, and whose
        request still owns the slot."""
        return {fl.slot for fl in self._pflights
                if self._slots[fl.slot] is fl.req}

    def _settle_prefills(self) -> bool:
        """Settle EVERY prefill in flight: wait on their copies (the
        last one's event covers the rest), read their first tokens,
        logprobs and top-K, and mark TTFT. Results for a slot cancelled
        or refilled in flight are discarded. False if none was in
        flight."""
        if not self._pflights:
            return False
        flights, self._pflights = self._pflights, []
        t0 = time.perf_counter()
        if self._prefill_hooks is not None:
            self._prefill_hooks.before_prefill_sync(flights)
        host = [fl.pull.get() for fl in flights]
        for fl, vals in zip(flights, host):
            if self._slots[fl.slot] is not fl.req:
                continue
            self._finish_prefill_host(fl.slot, fl.req, vals)
        self._add_phase("prefill_settle", time.perf_counter() - t0)
        return True

    def _finish_prefill_host(self, slot: int, req: _Request, vals) -> None:
        """The host half of a prefill's completion, from its settled
        packed results; its device half ran in the program."""
        self.cache_backend.on_prefill_complete(slot)
        self._host_len[slot] = req.tokens.size
        req.out.append(int(vals[0]))
        req.t_first = time.perf_counter()
        if req.trace is not None:
            # The first token is a host value: the request's TTFT point,
            # under overlap_prefill the settle, not the dispatch.
            req.trace.first_token()
        if self.logprobs:
            req.lps.append(float(vals[1]))
        k = self.top_logprobs
        if k:
            req.tlp = [(vals[2 + k:2 + 2 * k].astype(np.int64).tolist(),
                        vals[2:2 + k].tolist())]
        if req.prompt_logprobs:
            req.plp = self._stitch_plp(req, vals[2 + 2 * k:])

    @staticmethod
    def _stitch_plp(req: _Request, final) -> List[float]:
        """The prompt's per-token logprobs from the final program's
        scores and, for a chunked prompt, every earlier chunk's
        (in-chunk scores, boundary score) (the reference's
        `_stitch_plp` :1559). Position 0 reports 0.0."""
        if req.plp_pieces is None:
            return final[:req.tokens.size].tolist()
        flat = [0.0]
        done = 0
        for pull, sz in req.plp_pieces:
            v = pull.get()
            flat.extend(v[1:sz].tolist())
            flat.append(float(v[-1]))
            done += sz
        flat.extend(final[1:req.tokens.size - done].tolist())
        req.plp_pieces = None
        return flat

    # ---- chunked prefill ---------------------------------------------

    def _advance_prefills(self, budget: Optional[int]) -> int:
        """Run up to `budget` prefill chunks (all of them when None);
        returns how many ran. Lowest slot first, depth-first: chunk n+1
        follows chunk n while its rows are hot."""
        used = 0
        t_pf = time.perf_counter()
        settle0 = self._phase_s.get("prefill_settle", 0.0)
        while self._prefilling and (budget is None or used < budget):
            slot = min(self._prefilling)
            used += 1
            self.stats["prefill_chunks"] += 1
            req = self._slots[slot]
            off = self._prefilling[slot]
            s = min(self.prefill_chunk, req.tokens.size - off)
            pad = min(_bucket(s), self.max_len - off)
            final = off + s >= req.tokens.size
            self._stage(slot, req, off, s, pad)
            if final:
                key = self._final_key("chunk", pad, req)
            else:
                key = _Program(self._first_chunk_kind if off == 0
                               else "chunk", pad, final=False,
                               plp=req.prompt_logprobs)
            out = self._prefill_replay(key)
            if not final:
                if req.prompt_logprobs:
                    if req.plp_pieces is None:
                        req.plp_pieces = []
                    req.plp_pieces.append((HostPull(out), s))
                self._prefilling[slot] = off + s
                continue
            del self._prefilling[slot]
            self._dispatch_prefill(slot, req, HostPull(out))
            if not self.overlap_prefill:
                self._settle_prefills()
        if used:
            # The chunks' dispatch work; a final chunk's inline settle
            # timed itself into prefill_settle and is taken out.
            self._add_phase(
                "prefill_dispatch", time.perf_counter() - t_pf
                - (self._phase_s.get("prefill_settle", 0.0) - settle0))
        return used

    # A dense prompt's first chunk prefills fresh (kernel 2) into its
    # row; every later chunk continues it.
    _first_chunk_kind = "fresh"

    # ---- the engine step ---------------------------------------------

    def step(self) -> List[Tuple[Any, List[int]]]:
        """Fill free slots, run one decode window (decode_ticks ticks);
        returns the finished requests. The engine's metrics are written
        here, on the host.

        overlap_decode=True makes this a two-deep pipeline: the next
        window is queued against the current slot view before the
        previous window's results are waited for, so the card computes
        window k+1 while the host settles window k and admits. Requests
        admitted in a step join at the next window boundary; a slot
        whose request finished in the un-synced window decodes one more
        (frozen or discarded) window; settle discards results for slots
        cancelled or refilled in flight.

        overlap_prefill=True pipelines admission the same way: prefills
        queued in earlier steps settle first, and their slots join this
        step's window; admissions later in the step leave their prefill
        in flight. Both off is strict ordering."""
        finished: List[Tuple[Any, List[int]]] = []
        self.stats["engine_steps"] += 1
        t_step0 = time.perf_counter()
        self._sync_block_s = 0.0
        self._phase_s = {}
        synced = False
        settled_prefills = False
        if self._pflights:
            # Step boundary: the prefills queued in earlier steps settle
            # before the next window is queued, so their slots join it; a
            # request satisfied by its prefill alone finishes here.
            settled_prefills = self._settle_prefills()
            if settled_prefills:
                self._finish_check(finished)
        if self.overlap_decode and self._windows:
            # Keep the card busy across the sync: queue the next window
            # on the current slot view, then wait for the previous one.
            rows = self._active_rows()
            if any(rows):
                self.obs.occupancy.observe(sum(rows) / self.n_slots)
                self._dispatch_window(rows)
            t_settle0 = time.perf_counter()
            synced = self._settle_window(finished)
            self._phase_s["decode_sync"] = self._sync_block_s
            self._phase_s["settle"] = max(
                0.0, time.perf_counter() - t_settle0 - self._sync_block_s)
        t_fill0 = time.perf_counter()
        settle_fill0 = self._phase_s.get("prefill_settle", 0.0)
        prefills0 = self.stats["prefills"] + self.stats["prefill_chunks"]
        # Fill and check until stable: a request satisfied by its prefill
        # alone (max_new=1, instant EOS, a stop completed by the first
        # token) frees its slot for the next queued request. The prefill
        # budget is shared across the step; chunks under way go first,
        # so a stream of short prompts cannot starve a long one.
        remaining = self.max_prefills_per_step
        if self._prefilling:
            used = self._advance_prefills(remaining)
            if remaining is not None:
                remaining -= used
            self._finish_check(finished)
        while True:
            before = self.stats["prefills"]
            self._fill_slots(remaining)
            if remaining is not None:
                remaining -= self.stats["prefills"] - before
            n_done = len(finished)
            self._finish_check(finished)
            if len(finished) == n_done or (
                remaining is not None and remaining <= 0
            ):
                break
        if self._prefilling and (remaining is None or remaining > 0):
            # Long prompts admitted this step start their first chunk now.
            self._advance_prefills(remaining)
            self._finish_check(finished)
        if self.stats["prefills"] + self.stats["prefill_chunks"] > prefills0:
            # The prefill section's wall time, on steps that prefilled.
            self.obs.prefill_seconds.observe(time.perf_counter() - t_fill0)
        # Admission: the fill section minus the prefill dispatches and
        # any inline settles it ran.
        self._phase_s["admission"] = max(
            0.0, time.perf_counter() - t_fill0
            - self._phase_s.get("prefill_dispatch", 0.0)
            - (self._phase_s.get("prefill_settle", 0.0) - settle_fill0))
        active_rows = self._active_rows()
        if any(active_rows) and not self._windows:
            self.obs.occupancy.observe(sum(active_rows) / self.n_slots)
            if self.overlap_decode:
                # Pipeline warm-up (or refill after an idle gap): queue
                # and leave in flight; the next step settles it.
                self._dispatch_window(active_rows)
            else:
                sync0 = self._sync_block_s
                w = self._dispatch_window(active_rows)
                self._windows.pop()  # settled here, not by the pipeline
                decoded = self._sync_window(w)
                self._add_phase("decode_sync", self._sync_block_s - sync0)
                t_settle0 = time.perf_counter()
                self._apply_pairs(w.pairs, *decoded)
                self._finish_check(finished)
                self._add_phase("settle", time.perf_counter() - t_settle0)
                synced = True
        self._observe_cache_gauges()
        if synced:
            # The host's share of the step: wall time minus the time
            # blocked awaiting the window's results.
            self.obs.host_overhead.observe(max(
                0.0, time.perf_counter() - t_step0 - self._sync_block_s))
        self._observe_step_phases(t_step0, synced, finished, prefills0,
                                  settled_prefills)
        return finished

    def _observe_step_phases(self, t_step0: float, synced: bool,
                             finished, prefills0: int,
                             settled_prefills: bool = False) -> None:
        """Deposit this step's phase attribution (obs.STEP_PHASES), only
        for steps that did work; host_bookkeeping is the remainder, so
        the phases add up to the step's wall time."""
        did_work = (synced or settled_prefills or bool(finished)
                    or self.stats["prefills"] + self.stats["prefill_chunks"]
                    > prefills0)
        if not did_work or not self.obs.registry.enabled:
            return
        attributed = 0.0
        for phase in ("admission", "prefill_dispatch", "prefill_settle",
                      "decode_sync", "settle"):
            v = self._phase_s.get(phase, 0.0)
            attributed += v
            self.obs.step_phase.labels(phase=phase).observe(v)
        self.obs.step_phase.labels(phase="host_bookkeeping").observe(
            max(0.0, time.perf_counter() - t_step0 - attributed))

    def _observe_cache_gauges(self) -> None:
        """Per-step utilization gauges from host state only."""
        obs = self.obs
        if not obs.registry.enabled:
            return
        obs.slots_busy.set(sum(r is not None for r in self._slots))
        obs.queue_depth.set(len(self._queue))
        obs.kv_util.set(self.cache_backend.utilization())

    def _finish_check(self, finished) -> None:
        for i, req in enumerate(self._slots):
            if req is None or not req.out:
                # Mid-chunked-prefill or prefill-pending: no output yet.
                continue
            last = req.out[-1]
            nstop = req.hit_stop()
            if nstop is not None:
                req.out = req.out[:-nstop]
                req.lps = req.lps[:len(req.out)]
                if req.tlp is not None:
                    req.tlp = req.tlp[:len(req.out)]
            if nstop is not None or (
                self.eos_id is not None and last == self.eos_id
            ) or len(req.out) >= req.max_new:
                finished.append((req.rid, req.out))
                if self.logprobs:
                    self.finished_logprobs[req.rid] = req.lps[:len(req.out)]
                if self.top_logprobs and req.tlp is not None:
                    self.finished_top_logprobs[req.rid] = (
                        req.tlp[:len(req.out)]
                    )
                if req.plp is not None:
                    self.finished_prompt_logprobs[req.rid] = req.plp
                self.finished_timings[req.rid] = (
                    req.t_queued, req.t_admitted, req.t_first,
                    time.perf_counter(),
                )
                self.stats["requests_completed"] += 1
                self.stats["tokens_generated"] += len(req.out)
                self._slots[i] = None
                self._release_slot(i)

    # ---- decode windows: dispatch and settle -------------------------

    def _active_rows(self) -> List[bool]:
        """Slots a decode window advances now: occupied, not mid-chunked
        prefill, not awaiting a prefill's settle."""
        pending = (self._pending_prefill_slots() if self._pflights
                   else ())
        return [r is not None and i not in self._prefilling
                and i not in pending for i, r in enumerate(self._slots)]

    def _inflight_advance(self) -> Dict[int, int]:
        """Tokens the un-synced windows will have appended to each slot's
        current request by the time they settle (a continuing request
        takes the whole window; one that finished is discarded with its
        slot), so the host projects lengths without a sync."""
        adv: Dict[int, int] = {}
        for w in self._windows:
            for slot, req in w.pairs:
                if self._slots[slot] is req:
                    adv[slot] = adv.get(slot, 0) + w.ticks
        return adv

    def _dispatch_window(self, active_rows) -> _DecodeWindow:
        """Queue ONE decode window and start its results' copy to the
        host; record it in flight. No host sync."""
        adv = self._inflight_advance()
        ticks = self.decode_ticks
        self.cache_backend.pre_window(active_rows, adv, ticks)
        # The write guard forward_with_cache keeps runs at capture only,
        # so the window is checked here. An active slot writes one
        # position a tick from its length projected past the windows in
        # flight, and never past prompt + max_new - 1 (its budget freezes
        # it there); an idle one rewrites the position at its length.
        top = 0
        for i, req in enumerate(self._slots):
            if active_rows[i]:
                top = max(top, min(self._host_len[i] + adv.get(i, 0) + ticks,
                                   req.tokens.size + req.max_new - 1))
        if top > self._cache.max_len:
            raise ValueError(
                f"cache write up to position {top} passes "
                f"max_len={self._cache.max_len}"
            )
        # forward_with_cache's own check grows max_length a tick at a
        # time, as if every slot wrote every tick; starting it `ticks`
        # below the true bound makes it pass exactly when the bound does.
        self._cache.max_length = max(top - ticks, 0)
        greedy_only = all(
            r is None or r.temperature == 0.0 for r in self._slots
        )
        ctl = _Ctl(
            bias=any(b is not None for b in self._slot_bias),
            pen=any(self._slot_pen),
            seed=not greedy_only and any(
                r is not None and r.seed is not None for r in self._slots),
            con=any(d is not None for d in self._slot_dfa))
        if ctl.seed:
            # Each slot's generated-token count at the window's start,
            # projected past the windows in flight, so a seeded stream
            # draws the same numbers in any pipeline (the reference's
            # gen0, :2030).
            copy_from_host(self._sgen0, [
                len(r.out) + adv.get(i, 0) if r is not None else 0
                for i, r in enumerate(self._slots)])
        for i, act in enumerate(active_rows):
            if act != self._active_host[i]:
                _put(self._active, i, act)
                self._active_host[i] = act
        w = _DecodeWindow(
            [(i, self._slots[i]) for i in range(self.n_slots)
             if active_rows[i]],
            ticks, HostPull(self._decode_impl(greedy_only, ctl)))
        self._windows.append(w)
        self.stats["decode_windows"] += 1
        for slot, req in w.pairs:
            if req.trace is not None:
                req.trace.record("window-dispatch", src="engine",
                                 rid=req.rid, slot=slot, ticks=ticks,
                                 depth=len(self._windows))
        if self._window_hooks is not None:
            self._window_hooks.on_dispatch(w)
        return w

    def _sync_window(self, w: _DecodeWindow):
        """THE host sync of a window: wait for its packed results and cut
        each slot's valid prefix. Returns (tokens, logprobs or None,
        top-K or None) per slot."""
        t0 = time.perf_counter()
        if self._window_hooks is not None:
            self._window_hooks.before_sync(w)
        host = w.pull.get()  # (ticks, n_slots, 3 + 2K) fp64
        t1 = time.perf_counter()
        self._sync_block_s += t1 - t0
        # Window wall time, dispatch to results on the host (under
        # overlap it spans the host work interleaved with the window).
        self.obs.decode_window_seconds.observe(t1 - w.t_dispatch)
        toks = host[..., 0].astype(np.int64)
        # Valid ticks are a prefix (done is sticky): each slot's tokens
        # are a slice, and its cache grew by as many positions.
        n_valid = (host[..., 1] > 0).sum(axis=0)
        per_slot = [toks[:n_valid[i], i].tolist()
                    for i in range(self.n_slots)]
        if not self.logprobs:
            return per_slot, None, None
        per_lps = [host[:n_valid[i], i, 2].tolist()
                   for i in range(self.n_slots)]
        k = self.top_logprobs
        if not k:
            return per_slot, per_lps, None
        ids = host[..., 3 + k:3 + 2 * k].astype(np.int64)
        per_tl = [
            [(ids[j, i].tolist(), host[j, i, 3:3 + k].tolist())
             for j in range(n_valid[i])]
            for i in range(self.n_slots)
        ]
        return per_slot, per_lps, per_tl

    def _settle_window(self, finished) -> bool:
        """Sync and settle the OLDEST window in flight; False if none."""
        if not self._windows:
            return False
        w = self._windows.popleft()
        self._apply_pairs(w.pairs, *self._sync_window(w))
        self._finish_check(finished)
        return True

    def _decode_impl(self, greedy_only: bool, ctl: _Ctl = _NO_CTL):
        """One window through its variant's runner (a graph replay on the
        card, after the variant's first, eager window)."""
        key = (self.decode_ticks, greedy_only, *ctl)
        window = self._window_graphs.get(key)
        if window is None:
            window = self._window_graphs[key] = self._graph(
                functools.partial(self._window, greedy_only, ctl), self._gen)
        out = window()
        self.stats["decode_graphs"] = sum(
            w.graph is not None for w in self._window_graphs.values())
        return out

    def _window(self, greedy_only: bool, ctl: _Ctl = _NO_CTL):
        """decode_ticks single-token forwards over every slot (a runner
        keyed by decode_ticks only runs while it is the engine's). A
        slot whose sampled token is EOS, or whose budget runs out, sets
        its sticky done flag and freezes (length, stop state, token) for
        the rest of the window. The cache, the next tokens, the stop
        state and the token counts are written back in place. Returns
        the packed (ticks, n_slots, 3 + 2K) fp64 results: per tick and
        slot the token, its validity, its raw logprob, the top-K
        logprobs and ids."""
        cache, cur, active = self._cache, self._cur, self._active
        min_rem, rem, done = self._smin, self._srem, self._sdone
        rows = torch.arange(self.n_slots, device=self.device)
        outs = []
        for i in range(self.decode_ticks):
            act = active & ~done
            logits, grown = transformer.forward_with_cache(
                self.cfg, self.params, cur[:, None], cache,
                attn_impl=self.attn_impl,
            )
            cache.lengths.copy_(
                torch.where(act, grown.lengths, cache.lengths))
            cache.max_length = grown.max_length
            nxt, new_min, lp, tlv, tli = self._row_decode_step(
                logits[:, 0], cur, act, min_rem, greedy_only, ctl,
                self._sgen0 + i if ctl.seed else None)
            if ctl.pen:
                self._scounts.index_put_((rows, nxt), act.float(),
                                         accumulate=True)
            # This token ends the request when it is EOS (min_tokens has
            # banned EOS while its countdown runs) or the last of the
            # budget.
            fin = act & (rem <= 1)
            if self.eos_id is not None:
                fin = fin | (act & (nxt == self.eos_id))
            rem.copy_(torch.where(act, (rem - 1).clamp_min(0), rem))
            done.logical_or_(fin)
            min_rem.copy_(new_min)
            cur.copy_(nxt)
            outs.append(torch.cat(
                [nxt[:, None].double(), act[:, None].double(),
                 lp[:, None].double(), tlv.double(), tli.double()], dim=1))
        return torch.stack(outs)

    def _row_decode_step(self, logits, cur, act, min_rem, greedy_only,
                         ctl: _Ctl = _NO_CTL, gen_idx=None):
        """One tick's exit math over (n_slots, V) raw fp32 logits, in the
        reference's order (:775): the logit bias and EOS ban, the OpenAI
        penalties over the generated-token counts (presence once per
        seen token, frequency per count), the DFA mask of the
        constrained rows, sampling (greedy rows take the argmax; a
        seeded row draws from its own stream at `gen_idx`), the DFA
        state advance of the active constrained rows (in place), and
        logprob and top-K extraction from the raw distribution."""
        adj = self._adjust_logits(logits, min_rem,
                                  self._sbias if ctl.bias else None)
        if ctl.pen:
            counts = self._scounts
            adj = adj - (self._spres[:, None] * (counts > 0.0)
                         + self._sfreq[:, None] * counts)
        if ctl.con:
            con = self._coff >= 0
            row = self._ctrans.index_select(
                0, self._coff.clamp_min(0) + self._cstate)
            adj = self._mask_constrained(adj, row, con)
        if greedy_only:
            nxt = torch.argmax(adj, dim=-1)
        else:
            nxt = sample_batched(
                self._gen, adj, self._stemp, self._stopk, self._stopp,
                self._sminp, seed=self._sseed if ctl.seed else None,
                gen_idx=gen_idx)
        nxt = torch.where(act, nxt, cur)
        if ctl.con:
            self._cstate.copy_(torch.where(con & act,
                                           self._dfa_next(row, nxt),
                                           self._cstate))
        min_rem = torch.where(act, (min_rem - 1).clamp_min(0), min_rem)
        n = nxt.shape[0]
        lp = torch.zeros((n,), dtype=torch.float32, device=self.device)
        tlv = torch.zeros((n, 0), dtype=torch.float32, device=self.device)
        tli = torch.zeros((n, 0), dtype=torch.int64, device=self.device)
        if self.logprobs:
            lsm = torch.log_softmax(logits.float(), dim=-1)
            lp = torch.gather(lsm, 1, nxt[:, None])[:, 0]
            if self.top_logprobs:
                tlv, tli = torch.topk(lsm, self.top_logprobs, dim=-1)
        return nxt, min_rem, lp, tlv, tli

    def _apply_pairs(self, pairs, per_slot, per_lps, per_tl) -> None:
        """Append a window's valid tokens to the requests that owned the
        slots at dispatch. The identity check discards results for slots
        cancelled or refilled while the window was in flight; the
        per-token break re-checks the host-only finish conditions (stop
        sequences; EOS and budget were cut on the device and are checked
        again as the single source of truth)."""
        for slot, req in pairs:
            if self._slots[slot] is not req or slot in self._prefilling:
                # Results discarded, and no settle event: a cancelled
                # request's timeline ends at its cancellation.
                continue
            self._host_len[slot] += len(per_slot[slot])
            if req.trace is not None:
                req.trace.record("window-settle", src="engine",
                                 rid=req.rid, slot=slot,
                                 n_tokens=len(per_slot[slot]))
            for j, tok in enumerate(per_slot[slot]):
                req.out.append(int(tok))
                if per_lps is not None:
                    req.lps.append(float(per_lps[slot][j]))
                if per_tl is not None:
                    if req.tlp is None:
                        req.tlp = []
                    req.tlp.append(per_tl[slot][j])
                if (self.eos_id is not None and tok == self.eos_id) or (
                    len(req.out) >= req.max_new
                ) or req.hit_stop() is not None:
                    break

    # ---- live retuning -----------------------------------------------

    def set_decode_ticks(self, k: int) -> None:
        """Rewrite decode_ticks between windows (the autotuner's
        write-back); windows in flight keep the tick count they were
        queued with. The window graphs of other tick counts are dropped,
        after the windows in flight have landed."""
        k = int(k)
        if k < 1:
            raise ValueError(f"decode_ticks must be >= 1, got {k}")
        if k != self.decode_ticks:
            self.decode_ticks = k
            for w in self._windows:
                w.pull.get()
            self._window_graphs = {key: g for key, g in
                                   self._window_graphs.items()
                                   if key[0] == k}
        self.stats["decode_ticks"] = k

    def set_prefill_chunk(self, chunk: Optional[int]) -> None:
        """Rewrite prefill_chunk between steps (the prefill autotuner's
        write-back; None = whole prompts)."""
        if chunk is not None:
            chunk = int(chunk)
            if chunk < 1:
                raise ValueError(f"prefill_chunk must be >= 1, got {chunk}")
        self.prefill_chunk = chunk
        self.stats["prefill_chunk"] = chunk or 0

    # ---- cancellation and draining -----------------------------------

    def _drain_flights(self) -> None:
        """Wait for every window and prefill in flight and discard their
        results, so none can be attributed to a later request and the
        card is quiet for the caller. The hooks are not consulted: this
        is cleanup, not a measured settle."""
        while self._windows:
            self._windows.popleft().pull.get()
        while self._pflights:
            self._pflights.pop().pull.get()

    def cancel(self, rid) -> bool:
        """Drop a queued or running request; its slot frees at once. A
        program in flight for it settles into nothing (identity check);
        the slot's device rows need no repair."""
        for i, req in enumerate(self._slots):
            if req is not None and req.rid == rid:
                self._slots[i] = None
                self._prefilling.pop(i, None)
                self._release_slot(i)
                self.finished_logprobs.pop(rid, None)
                self.finished_top_logprobs.pop(rid, None)
                self.finished_prompt_logprobs.pop(rid, None)
                self.stats["requests_cancelled"] += 1
                if req.trace is not None:
                    req.trace.abort("cancelled")
                return True
        for req in list(self._queue):
            if req.rid == rid:
                self._queue.remove(req)
                self.stats["requests_cancelled"] += 1
                if req.trace is not None:
                    req.trace.abort("cancelled")
                return True
        return False

    def abort_all(self) -> List[Any]:
        """Drop every queued and running request; returns their rids.
        Windows and prefills in flight are drained and discarded first.
        The backend's allocator returns to its pristine state."""
        self._drain_flights()
        dropped = []
        for req in self._queue:
            dropped.append(req.rid)
            if req.trace is not None:
                req.trace.abort("cancelled")
        self._queue.clear()
        for i, req in enumerate(self._slots):
            if req is None:
                continue
            dropped.append(req.rid)
            if req.trace is not None:
                req.trace.abort("cancelled")
            self._slots[i] = None
            self._release_slot(i)
        self._prefilling.clear()
        self.finished_logprobs.clear()
        self.finished_top_logprobs.clear()
        self.finished_prompt_logprobs.clear()
        self.cache_backend.reset()
        self.stats["requests_cancelled"] += len(dropped)
        return dropped

    @property
    def pending(self) -> int:
        return len(self._queue) + sum(r is not None for r in self._slots)

    def close(self) -> None:
        """Drain what is in flight, then drop the captured graphs, their
        inputs and the device cache, so their memory returns to the
        allocator; the engine cannot step afterwards. Call it on the
        thread that drives the engine, or once that thread has exited:
        freeing a graph is a CUDA call, which a capture running on
        another thread would refuse."""
        self._drain_flights()
        self._window_graphs = {}
        self._prefill_graphs = {}
        self._pf_in = self._pf_mini = self._pf_zero = None
        self._ctrans, self._cres = None, {}
        self._beam_delegate, self._beams = None, {}
        self._cache = None

    def run(self, requests=None) -> Dict[Any, List[int]]:
        """Drain: submit (rid, tokens, max_new) triples, step to empty."""
        for r in requests or ():
            self.submit(*r)
        results: Dict[Any, List[int]] = {}
        while self.pending:
            for rid, out in self.step():
                results[rid] = out
        return results

    # ---- beam search (dense caches) ----------------------------------

    def beam_search(self, prompt_tokens, *, num_beams: int = 4,
                    max_new_tokens: int = 32, eos_id=None,
                    length_penalty: float = 1.0, constraint=None):
        """Deterministic beam decode of ONE prompt on this engine's
        params (the reference's :2407): the server's `num_beams`. The
        dense caches delegate to a lazily built single-request Engine
        sharing the params and this engine's program runners; it keeps
        its own (num_beams, length) beam caches (Engine.beam_search), so
        the slot batch is untouched and the windows in flight, which
        write only the slot cache, precede it in stream order. The paged
        subclass overrides this with its copy-on-write search over the
        pool. Call it on the engine's thread, as step() and submit()."""
        if eos_id is None:
            eos_id = self.eos_id
        if self._beam_delegate is None:
            self._beam_delegate = Engine(
                self.cfg, self.params, max_len=self.max_len,
                kv_quant=self.kv_quant, attn_impl=self.attn_impl,
                device=self.device)
            # Its programs run as this engine's do: graphs on the card.
            self._beam_delegate._graph = self._graph
        return self._beam_delegate.beam_search(
            prompt_tokens, num_beams=num_beams,
            max_new_tokens=max_new_tokens, eos_id=eos_id,
            length_penalty=length_penalty, constraint=constraint)

    # ---- not ported yet ----------------------------------------------

    def preempt(self, rid):
        raise NotImplementedError("preemption is not ported yet")

    def release_frozen(self, rid):
        raise NotImplementedError("frozen slots are not ported yet")


class PagedBatchingEngine(BatchingEngine):
    """Continuous batching over a shared block pool (paged KV cache).

    Slots borrow `block_size`-token blocks from one pool and return them
    on completion; `pool_tokens` (default: half the dense footprint) is
    the capacity knob, and admission waits in the queue while the pool
    cannot cover a request's footprint. Block 0 is scratch. Decode
    attends through the block tables (`paged_decode_attention`). An int8
    pool (`paged-int8`) defaults to 64-token blocks. `prefix_cache=True`
    keeps full prompt blocks cached across requests (cache/paged.py);
    a hit prefills only the suffix.
    """

    _backend_family = ("paged", "paged-int8")
    # Every chunk continues through the block table, the first included.
    _first_chunk_kind = "chunk"

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        *,
        n_slots: int = 8,
        max_len: Optional[int] = None,
        block_size: Optional[int] = None,
        pool_tokens: Optional[int] = None,
        prefix_cache: bool = False,
        cache_backend=None,
        kv_quant: Optional[str] = None,
        **kw,
    ):
        if not isinstance(cache_backend, CacheBackend):
            name = resolve_backend_name(cache_backend,
                                        paged=cache_backend is None,
                                        kv_quant=kv_quant)
            if name not in self._backend_family:
                raise ValueError(
                    f"{type(self).__name__} drives cache backends "
                    f"{self._backend_family}; {name!r} needs a different "
                    "engine class (inference.cache.engine_class)"
                )
            if block_size is None:
                # The JAX engines' defaults: int8 pools take 64-token
                # blocks, the others 16.
                block_size = 64 if name == "paged-int8" else 16
            cache_backend = make_backend(
                name, cfg, n_slots, max_len or cfg.max_seq_len,
                block_size=block_size, pool_tokens=pool_tokens,
                prefix_cache=prefix_cache,
            )
        elif (block_size is not None
              and block_size != cache_backend.block_size) \
                or pool_tokens is not None:
            raise ValueError(
                "block_size and pool_tokens cannot reshape a constructed "
                f"{cache_backend.name!r} backend; pass them to its "
                "constructor"
            )
        elif prefix_cache and not getattr(cache_backend, "prefix_cache",
                                          False):
            raise ValueError(
                f"prefix_cache=True conflicts with the "
                f"{cache_backend.name!r} backend instance "
                "(constructed without prefix_cache)"
            )
        # Read by submit and by the server's capability checks.
        self.prefix_cache = bool(getattr(cache_backend, "prefix_cache",
                                         False))
        super().__init__(cfg, params, n_slots=n_slots, max_len=max_len,
                         cache_backend=cache_backend, kv_quant=kv_quant,
                         **kw)
        self.block_size = self.cache_backend.block_size

    def _scatter_prefill(self, mini, slot) -> None:
        """Scatter a prefilled mini's pad positions through the slot's
        table row (`slot` a (1,) device tensor; positions past the slot's
        blocks land in scratch block 0)."""
        self._scatter_row(mini, self._cache.tables.index_select(0, slot)[0])
        self._cache.lengths.index_copy_(0, slot, mini.lengths)

    def _scatter_row(self, mini, row) -> None:
        """Scatter a batch-1 mini's pad positions into the pool through
        one table row (max_blocks,). An int8 mini's scales scatter
        through the same (block, offset) coordinates."""
        cache, bs = self._cache, self.block_size
        pos = torch.arange(mini.k.shape[3], device=self.device)
        blocks = row.to(torch.int64)[pos // bs]
        offs = pos % bs
        # Advanced indices at dims 1 and 3 (split by the head slice) put
        # the token rows first: the target is (S, L, Hkv[, Dh]), from the
        # mini's (L, Hkv, S[, Dh]).
        for name in kv_field_names(self.kv_quant):
            src = getattr(mini, name)[:, 0]
            getattr(cache, name)[:, blocks, :, offs] = src.movedim(2, 0)

    def _chunk_forward(self, pad: int, tokens, slot, s, off):
        """Continue the slot's prompt past `off` resident tokens through a
        batch-1 view of its table row over the shared pool (the
        reference's `_prefix_prefill_impl` :2640; every device value a
        tensor, the row taken by `index_select` on the device slot):
        every chunk, the first included, and a prefix hit's suffix
        attend through the plain paged attention, as the JAX engine pins
        them (reason at :2655-2658). Pad positions past the slot's
        blocks land in scratch block 0; the view's host max_length is
        fixed per pad (the host checked off + pad <= max_len)."""
        cache = self._cache
        view = cache.replace(
            tables=cache.tables.index_select(0, slot),
            lengths=off.to(torch.int32), max_length=self.max_len - pad)
        logits, _ = transformer.forward_with_cache(
            self.cfg, self.params, tokens, view, attn_impl="ref",
        )
        cache.lengths.index_copy_(0, slot, (off + s).to(torch.int32))
        return logits

    def _run_prefill(self, slot: int, req: _Request) -> HostPull:
        """A prefix hit prefills only the unmatched suffix, through the
        continuation program (the reference's :2610): its pad is capped
        at the table space left past the prefix."""
        p = self.cache_backend.prefill_offset(slot)
        if p == 0:
            return super()._run_prefill(slot, req)
        s = req.tokens.size - p  # >= 1 by the match cap
        pad = min(_bucket(s), self.max_len - p)
        self._stage(slot, req, p, s, pad)
        return HostPull(self._prefill_replay(self._final_key("chunk", pad,
                                                             req)))

    # ---- beam search over the pool (copy-on-write tables) ------------

    def beam_search(self, prompt_tokens, *, num_beams: int = 4,
                    max_new_tokens: int = 32, eos_id=None,
                    length_penalty: float = 1.0, constraint=None):
        """Deterministic beam decode of ONE prompt over the block pool
        (the reference's :2752): Engine.beam_search's contract and, by
        the shared beam math, its beams.

        Copy-on-write: the prompt prefills once into ceil(s / bs)
        borrowed blocks that every beam's table shares read-only (with
        prefix_cache=True a cached chain covering a prompt prefix
        attaches read-only instead, counted in the prefix stats, and
        only the suffix is computed, through the plain attention as the
        slots' suffixes are); each beam owns one statically assigned
        block per generated logical block (beams advance in lockstep, so
        the assignment never collides); on a reorder the tables are
        gathered and each live beam copies its partial tail block into
        its own (gathering every source before writing any), and a
        frozen beam's table points at scratch block 0. Sealed blocks
        stay shared, never copied; int8 pools move their scales in
        lockstep. The blocks come from the engine's allocator (evicting
        unreferenced prefix blocks when the free list is dry) and return
        in a `finally`; slots' tables and lengths are untouched. Every
        program in flight was queued before the search and every later
        one after it, on the one stream, so a block released at a
        settle while a window in flight still writes it is written
        before the search borrows it. Call it on the engine's thread.
        """
        k_beams, steps = int(num_beams), int(max_new_tokens)
        if k_beams < 1:
            raise ValueError("num_beams must be >= 1")
        if steps < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if eos_id is None and constraint is not None:
            eos_id = self.eos_id
        dfa, eos_id = check_beam_constraint(constraint, eos_id,
                                            self.cfg.vocab_size)
        toks = np.asarray(prompt_tokens, np.int64).reshape(-1)
        s, bs, be = int(toks.size), self.block_size, self.cache_backend
        if s + steps + 1 > self.max_len:
            raise ValueError(
                f"prompt {s} + max_new {steps} exceeds max_len "
                f"{self.max_len}"
            )
        lb0 = s // bs
        # Owned generated blocks cover every copy-on-write target: the
        # steps write positions s .. s + steps - 2 (the reference counts
        # one more position, its copy after the last step; its count is
        # kept, so the pool refuses the searches it refuses).
        n_gen = 0 if steps == 1 else ((s + steps - 1) // bs - lb0 + 1)
        matched: List[int] = []
        if self.prefix_cache:
            _, matched = be.attach_prefix(toks)
        m_tokens = len(matched) * bs
        prompt_n = -(-s // bs) - len(matched)
        need = prompt_n + k_beams * n_gen
        if need > len(be._free) + be.evictable():
            be.detach_prefix(matched)
            raise RuntimeError(
                f"paged pool exhausted: beam search needs {need} "
                f"blocks ({prompt_n} suffix-prompt past "
                f"{len(matched)} cached prefix blocks + "
                f"{k_beams}x{n_gen} owned tails); free "
                f"{len(be._free)} + evictable {be.evictable()}"
            )
        if self.prefix_cache:
            # Counted once the attach is certain, as a slot's.
            self.stats["prefix_hit_tokens"] += m_tokens
            self.stats["prefix_query_tokens"] += s
        borrowed = [be.alloc_block() for _ in range(need)]
        be.peak_blocks_used = max(be.peak_blocks_used, be.blocks_used())
        try:
            st = self._beam_state(k_beams, eos_id, dfa)
            row = np.zeros((self._cache.max_blocks,), np.int64)
            row[:len(matched) + prompt_n] = matched + borrowed[:prompt_n]
            gen = np.zeros((self._cache.max_blocks, k_beams), np.int64)
            gen[:n_gen] = np.asarray(borrowed[prompt_n:]).reshape(
                n_gen, k_beams)
            # Only the suffix past the matched prefix is computed; its
            # pad is capped at the table space past the prefix (a pad
            # past the table would index outside the row).
            s_suf = s - m_tokens
            pad = min(_bucket(s_suf), self.max_len - m_tokens)
            staged = np.zeros((self._BEAM_HEAD + pad,), np.int64)
            staged[:self._BEAM_HEAD] = (s, s_suf, m_tokens, lb0, n_gen)
            staged[self._BEAM_HEAD:self._BEAM_HEAD + s_suf] = toks[m_tokens:]
            copy_from_host(st.inp[:self._BEAM_HEAD + pad], staged)
            copy_from_host(st.tables, np.tile(row, (k_beams, 1)))
            copy_from_host(st.gen, gen)
            key = (pad, m_tokens > 0)
            prefill = st.prefills.get(key)
            if prefill is None:
                prefill = st.prefills[key] = self._graph(functools.partial(
                    self._beam_paged_impl, st, pad, m_tokens > 0, eos_id),
                    None)
            # Captured at the key's first search (Engine.beam_search).
            call_captured(prefill)
            if steps > 1:
                if st.step is None:
                    st.step = self._graph(functools.partial(
                        self._beam_paged_step, st, eos_id), None)
                for _ in range(steps - 1):
                    st.step()
            got = _pull_beams(*beam_rank(st.scores, st.out[:, :steps],
                                         st.lens, length_penalty))
        finally:
            be._free.extend(borrowed)
            be.detach_prefix(matched)
        return beam_filter_invalid(*got)

    # The beam programs' staged header: (prompt length, suffix length,
    # cached prefix length, the prompt's last logical block, owned
    # blocks per beam), then the suffix's padded tokens.
    _BEAM_HEAD = 5

    def _beam_state(self, k: int, eos_id: Optional[int], dfa) -> "_PagedBeam":
        """The (K, eos_id, constrained) key's buffers, built at its first
        search, with the DFA's rows uploaded when another table than the
        resident one is asked for (a larger table rebuilds the key)."""
        key = (k, eos_id, dfa is not None)
        st = self._beams.get(key)
        if st is not None and dfa is not None \
                and st.ctrans.shape[0] < dfa.n_states:
            st = None
        if st is None:
            dev, mb = self.device, self._cache.max_blocks

            def zeros(*shape, dtype):
                return torch.zeros(shape, dtype=dtype, device=dev)

            st = self._beams[key] = _PagedBeam(
                inp=zeros(self._BEAM_HEAD + self.max_len, dtype=torch.int64),
                tables=zeros(k, mb, dtype=torch.int32),
                gen=zeros(mb, k, dtype=torch.int64),
                lengths=zeros(k, dtype=torch.int32),
                cur=zeros(k, dtype=torch.int64),
                scores=zeros(k, dtype=torch.float32),
                finished=zeros(k, dtype=torch.bool),
                out=zeros(k, self.max_len, dtype=torch.int64),
                lens=zeros(k, dtype=torch.int32),
                cstate=zeros(k, dtype=torch.int64),
                at=zeros(1, dtype=torch.int64),
                ctrans=_dfa_table(dfa, self.cfg.vocab_size, dev))
        _upload_dfa(st, dfa)
        return st

    def _beam_paged_impl(self, st: "_PagedBeam", pad: int, has_prefix: bool,
                         eos_id: Optional[int]) -> None:
        """The device side's first program (the reference's
        `_beam_paged_impl` up to its scan, :2940-3030): the prompt
        prefilled once through the shared table row, the first
        expansion, and frozen beams' tables pointed at scratch block 0.
        Without a prefix the padded prompt runs through the mini cache
        (kernel 2) and scatters through the shared row: pad positions
        past the prompt land in its tail block at offsets the beams
        overwrite before reading, or in block 0. With one the suffix
        continues the cached prefix through the row's view on the plain
        attention, as the reference pins it (:2955). Reads only the
        key's fixed buffers."""
        h = self._BEAM_HEAD
        s, s_suf, m = (st.inp[i:i + 1] for i in range(3))
        tokens = st.inp[h:h + pad][None]
        if has_prefix:
            view = self._cache.replace(
                tables=st.tables[:1], lengths=m.to(torch.int32),
                max_length=self.max_len - pad)
            logits, _ = transformer.forward_with_cache(
                self.cfg, self.params, tokens, view, attn_impl="ref",
            )
            last = logits[0].index_select(0, s_suf - 1)[0]
        else:
            self._prefill_inputs()
            mini = self._pf_mini
            view = mini.replace(
                **{n: getattr(mini, n)[:, :, :, :pad]
                   for n in kv_field_names(self.kv_quant)},
                lengths=self._pf_zero, max_length=0)
            logits, _ = transformer.forward_with_cache(
                self.cfg, self.params, tokens, view, fresh_cache=True,
                attn_impl=self.attn_impl,
            )
            self._scatter_row(view, st.tables[0])
            last = logits[0].index_select(0, s - 1)[0]
        k = st.cur.shape[0]
        # beam0 is 0 for every beam and the rows are equal: the
        # reference's table gather is a no-op.
        scores, _, tok, cstate = beam_first_expand(last, k, st.ctrans,
                                                   eos_id)
        st.lengths.copy_(s.to(torch.int32).expand(k))
        st.scores.copy_(scores)
        st.cur.copy_(tok)
        if eos_id is not None:
            torch.eq(tok, eos_id, out=st.finished)
        else:
            st.finished.zero_()
        st.out.zero_()
        st.out[:, 0].copy_(tok)
        st.lens.fill_(1)
        st.cstate.copy_(cstate)
        st.at.fill_(1)
        st.tables.masked_fill_(st.finished[:, None], 0)

    def _beam_cow(self, st: "_PagedBeam") -> None:
        """Each live beam owns the tail block it is about to write: the
        (possibly shared) partial tail is copied into the beam's
        statically assigned block and its table entry repointed. Every
        source is gathered before any block is written, since a beam may
        adopt the tail another beam rewrites in the same step. Frozen
        beams copy block 0 onto itself."""
        bs = self.block_size
        lb0, n_gen = st.inp[3:4], st.inp[4:5]
        live = ~st.finished
        lb = (st.lengths // bs).to(torch.int64)
        j = torch.minimum((lb - lb0).clamp(min=0), n_gen - 1)
        ak = torch.arange(lb.shape[0], device=lb.device)
        owned = torch.where(live, st.gen[j, ak], 0)
        tail = st.tables.gather(1, lb[:, None])[:, 0].to(torch.int64)
        src = torch.where(live, tail, 0)
        for name in kv_field_names(self.kv_quant):
            pool = getattr(self._cache, name)
            pool.index_copy_(1, owned, pool.index_select(1, src))
        st.tables.scatter_(1, lb[:, None],
                           torch.where(live, owned, tail).to(
                               torch.int32)[:, None])

    def _beam_paged_step(self, st: "_PagedBeam",
                         eos_id: Optional[int]) -> None:
        """One beam step over the pool (the reference's `beam_step`
        :3040-3066): copy-on-write of the live beams' tails (the
        reference's copy at the end of the previous step, moved here so
        the last step does not copy for nothing), the cached forward
        through the beams' tables (kernel 7), the shared expansion, the
        tables and lengths gathered by beam, a frozen beam's length
        rolled back and its table pointed at scratch block 0. The host
        checked that the whole search fits the table."""
        self._beam_cow(st)
        view = self._cache.replace(tables=st.tables, lengths=st.lengths,
                                   max_length=0)
        logits, grown = transformer.forward_with_cache(
            self.cfg, self.params, st.cur[:, None], view,
            attn_impl=self.attn_impl,
        )
        (scores, beam, tok, out, lens, finished, was_done,
         cstate) = beam_expand(logits[:, 0], st.scores, st.finished, st.out,
                               st.lens, st.at, eos_id, st.ctrans, st.cstate)
        tables = st.tables.index_select(0, beam)
        lengths = grown.lengths.index_select(0, beam)
        st.tables.copy_(tables.masked_fill_(finished[:, None], 0))
        st.lengths.copy_(torch.where(was_done, lengths - 1, lengths))
        st.cur.copy_(tok)
        st.scores.copy_(scores)
        st.finished.copy_(finished)
        st.out.copy_(out)
        st.lens.copy_(lens)
        st.cstate.copy_(cstate)
        st.at.add_(1)

    def _observe_cache_gauges(self) -> None:
        super()._observe_cache_gauges()
        if self.prefix_cache and self.obs.registry.enabled:
            self.obs.prefix_blocks.set(
                len(self.cache_backend._hash_to_block))
