"""Continuous-batching serving engine.

North-star config 3 (BASELINE.json: "LLM.int8() inference, 1 host,
continuous batching") and SURVEY.md §7 layer 6 / hard part 5: a host-side
scheduler feeding fixed-shape jitted device programs, so nothing ever
recompiles mid-serve:

  admit   — when a slot is free and the page pool has room, pop the next
            waiting request, dispatch its prefill (bucketed static
            length) + first-token sampling ON DEVICE, scatter the prompt
            KV into freshly allocated pages, and seat it. Nothing is read
            back: the first token chains into the next decode window as a
            device scalar, so admission costs the step loop only the
            dispatch (the prefill computes on-chip, in line with decode).
  decode  — ``multi_step`` tokens for ALL active slots per dispatch
            through the paged decode program (serve/runner.py), lazily
            allocating a new KV page only when a sequence actually
            crosses a page boundary.
  retire  — on EOS or max_new_tokens, free the slot + its pages and
            record completion; the next admit reuses them immediately.

Readback hiding: every dispatched token batch starts an async
device->host copy immediately, and the engine keeps up to
``pipeline_depth`` windows in flight before it processes the oldest — by
which time the copy has landed, so host bookkeeping does not wait on the
device. Sampled tokens chain step-to-step on device, so the deferred
processing never feeds the device stale inputs. (The depth and the window
length were sized for a high-latency device link; their values on a
local GPU are still to be measured.)

Metrics per request: TTFT (arrival -> first token visible on host) and
decode latency; aggregate throughput from the step loop. These are the
BASELINE.json metric set (tokens/sec/chip, p50 TTFT).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from quanta_tpu.models.llama import LlamaConfig
from quanta_tpu.serve import kvcache, runner
from quanta_tpu.serve.sampling import SamplingParams


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    # filled in by the engine
    output: List[int] = dataclasses.field(default_factory=list)
    t_arrival: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0

    @property
    def ttft(self) -> float:
        return self.t_first_token - self.t_arrival

    @property
    def finished(self) -> bool:
        return self.t_done > 0


@jax.jit
def _scatter_token(row: jax.Array, idx: jax.Array, tok: jax.Array):
    """row.at[idx] = tok with a DYNAMIC index: one compiled program for
    every slot (a python-int index would bake into the HLO and compile
    once per slot value)."""
    return row.at[idx].set(tok)


@jax.jit
def _merge_rows(old: jax.Array, new: jax.Array, mask: jax.Array):
    return jnp.where(mask, new, old)


@jax.jit
def _set_page(table: jax.Array, slot: jax.Array, idx: jax.Array,
              page: jax.Array):
    """Write one page id into the device-resident page table (dynamic
    indices: one compiled program per table width). Lets page growth
    update the cached device table in place instead of dirtying the
    steady-state dispatch path — growth is the most frequent scheduling
    event (every page_size tokens per slot), and without this the engine
    re-uploads its whole dispatch state every couple of windows."""
    return table.at[slot, idx].set(page)


@jax.jit
def _set_pages(table: jax.Array, slots: jax.Array, idxs: jax.Array,
               pages: jax.Array):
    """Batched form of _set_page: one scatter for a window's worth of page
    growth (padded to a power of two by REPEATING the last patch, so
    duplicate entries always carry the same value and the scatter stays
    deterministic)."""
    return table.at[slots, idxs].set(pages)


@dataclasses.dataclass
class _Slot:
    request: Optional[Request] = None
    pages: List[int] = dataclasses.field(default_factory=list)
    seq_len: int = 0  # tokens whose KV is already in the pool
    last_token: int = 0
    admit_seq: int = 0  # monotone admission order (preemption picks newest)

    @property
    def busy(self) -> bool:
        return self.request is not None


class Engine:
    """Single-host continuous-batching engine over a (possibly sharded,
    possibly quantized) Llama param tree."""

    def __init__(
        self,
        params,
        cfg: LlamaConfig,
        *,
        n_slots: int = 8,
        page_size: int = 16,
        n_pages: Optional[int] = None,
        prefill_buckets: Sequence[int] = (32, 64, 128, 256, 512, 1024),
        eos_id: Optional[int] = None,
        use_kernel: Optional[bool] = None,
        top_k: int = 0,
        max_top_k: int = 0,
        max_admits_per_step: Optional[int] = None,
        kv_quant: bool = False,
        rng_seed: int = 0,
        recorder=None,
        pipeline: bool = True,
        pipeline_depth: int = 2,
        multi_step: int = 1,
        arch: str = "llama",
    ):
        self.params = params
        self.cfg = cfg
        self.arch = arch  # serving architecture (runner.ARCHS key)
        self.n_slots = n_slots
        self.page_size = page_size
        # top_k: engine-wide static truncation applied to every request.
        # max_top_k: static CAP under which each request's own sampling.top_k
        # is honored every step (0 disables per-request top-k; requests
        # asking for it are rejected at submit instead of silently ignored).
        self.top_k = top_k
        self.max_top_k = max_top_k
        # None = admit into every free slot each step (standard continuous
        # batching). An int bounds how much prefill device time newcomers
        # can inject between decode windows — a latency knob, NOT the
        # default: under sustained load a budget of 1 makes admission the
        # binding constraint (one window plus one readback per
        # admission).
        self.max_admits_per_step = max_admits_per_step
        self.prefill_buckets = tuple(
            sorted({b for b in prefill_buckets if b < cfg.max_seq_len}
                   | {cfg.max_seq_len})
        )
        self.eos_id = eos_id
        self.use_kernel = use_kernel
        if n_pages is None:  # default: room for every slot at max_seq_len
            n_pages = 1 + n_slots * -(-cfg.max_seq_len // page_size)
        self.max_pages_per_slot = -(-cfg.max_seq_len // page_size)
        self.kv_quant = kv_quant
        self.pool = kvcache.init_pool(cfg, n_pages, page_size,
                                      kv_quant=kv_quant)
        # decode-step page-table width buckets (doubling up to the max):
        # the jitted decode step reads the pool through the table, so its
        # memory traffic scales with the WIDEST active sequence's bucket, not
        # with max_seq_len — one compile per bucket, like prefill buckets.
        self.decode_page_buckets = []
        b = 1
        while b < self.max_pages_per_slot:
            self.decode_page_buckets.append(b)
            b *= 2
        self.decode_page_buckets.append(self.max_pages_per_slot)
        self.alloc = kvcache.PageAllocator(n_pages)
        self.slots = [_Slot() for _ in range(n_slots)]
        self.waiting: Deque[Request] = deque()
        self.finished: List[Request] = []
        self._page_table = np.zeros(
            (n_slots, self.max_pages_per_slot), np.int32
        )
        self._rng = jax.random.PRNGKey(rng_seed)
        # decode-path RNG lives ON DEVICE (split in-program each step);
        # the host never reads it. Admission sampling keys split from
        # self._rng on host but sample on device.
        self._dev_key = jax.random.PRNGKey(rng_seed + 1)
        # device-resident scheduler state: when no scheduling event
        # (admit/retire/preempt/growth) happened since the last dispatch
        # and the active set is unchanged, the next dispatch reuses the
        # previous step's returned positions and the cached page table /
        # sampling params — zero host->device uploads per steady step.
        self._dev = None
        # (slot, col, page) writes destined for the cached device page
        # table, applied as ONE batched scatter per dispatch: growth is
        # the most frequent scheduling event (one page per active slot
        # per window at multi_step ~= page_size) and a per-page eager
        # patch is one host dispatch each.
        self._table_patches = []
        self._sched_dirty = True
        # pipelined stepping: each step() dispatches device programs
        # WITHOUT reading them back and keeps up to ``pipeline_depth``
        # token batches in flight; the oldest is processed only once the
        # queue exceeds the depth, by which time its async device->host
        # copy (started at dispatch) has landed — host bookkeeping never
        # waits on the device. pipeline=False processes every batch in the
        # step that dispatched it (depth 0, the synchronous oracle).
        self.pipeline = pipeline
        self.pipeline_depth = max(0, pipeline_depth) if pipeline else 0
        # multi-token scheduling: dispatch up to ``multi_step`` decode
        # steps in ONE device program (runner.decode_multi_step), paying
        # one dispatch + one readback per window instead of per token.
        # Amortizes per-dispatch host cost; admission/retire granularity
        # becomes the window. 1 = per-token (lowest TTFT jitter).
        self.multi_step = max(1, multi_step)
        # in-flight decode windows, FIFO. Each entry:
        #   {"ids": [(slot, uid, seat)], "tokens": device array
        #    ((off + k, n_slots)), "k": decode tokens per listed slot,
        #    "off": 1 if row 0 is the window's INPUT token row,
        #    "admits": [(slot, uid, seat)] whose first generated token is
        #    that input row (admission piggybacks its token on the next
        #    window's readback: zero extra round trips per admission)}
        self._pending: Deque[dict] = deque()
        # slots admitted since the last dispatch: their first token rides
        # row 0 of the next window that includes them
        self._fresh_admit: Dict[int, Tuple[int, int]] = {}
        # device-resident last-sampled-token row, one entry per slot:
        # updated at every admission (scatter) and every decode dispatch
        # (masked merge of the window's final token row), so it is ALWAYS
        # the freshest input token for every seated slot — dispatches
        # read it directly and never wait for host processing.
        self._tok_row = jnp.zeros((n_slots,), jnp.int32)
        self._steps = 0
        self._decode_tokens = 0
        self._t_serve = 0.0
        self._t_first_dispatch = 0.0
        self._t_last_process = 0.0
        self._admit_counter = 0
        self._preemptions = 0
        self.recorder = recorder  # optional quanta_tpu.metrics.MetricsRecorder

    # ------------------------------------------------------------- intake

    def submit(self, req: Request) -> None:
        """Enqueue a request, rejecting up front anything the engine could
        never serve (so the step loop can't deadlock on the head of line)."""
        prompt_len = len(req.prompt)
        # multi_step > 1 reserves window headroom: a retire discovered
        # mid-window may have written up to multi_step-1 positions past
        # the request's own budget
        total_len = prompt_len + req.max_new_tokens + self.multi_step - 1
        if total_len > self.cfg.max_seq_len:
            raise ValueError(
                f"request {req.uid}: prompt ({prompt_len}) + max_new_tokens "
                f"({req.max_new_tokens}) + window headroom "
                f"({self.multi_step - 1}) exceeds max_seq_len "
                f"{self.cfg.max_seq_len}"
            )
        worst_pages = self._pages_needed(total_len)
        capacity = self.alloc.n_pages - 1  # page 0 is the reserved null page
        if worst_pages > capacity:
            raise ValueError(
                f"request {req.uid}: worst-case page need {worst_pages} "
                f"exceeds pool capacity {capacity}; raise n_pages"
            )
        if req.sampling.top_k > self.max_top_k:
            raise ValueError(
                f"request {req.uid}: sampling.top_k={req.sampling.top_k} "
                f"exceeds the engine's static max_top_k={self.max_top_k}; "
                "construct the Engine with a larger max_top_k"
            )
        req.t_arrival = req.t_arrival or time.perf_counter()
        self.waiting.append(req)

    # ----------------------------------------------------------- scheduler

    def _pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def _in_flight(self, slot_id: int, uid: int) -> int:
        """Tokens dispatched for (slot, uid) that the host has not yet
        processed (across all pending batches)."""
        n = 0
        for e in self._pending:
            for s, u, _seat in e["ids"]:
                if s == slot_id and u == uid:
                    n += e["k"]
        return n

    def _try_admit(self) -> bool:
        """Seat one waiting request into a free slot. Returns True if
        seated. Fully asynchronous: prefill, KV scatter and first-token
        sampling are dispatched to the device and the token readback is
        deferred to pending processing — the step loop never blocks here."""
        if not self.waiting:
            return False
        free = [i for i, s in enumerate(self.slots) if not s.busy]
        if not free:
            return False
        req = self.waiting[0]
        prompt_len = len(req.prompt)
        bucket = runner.pick_bucket(prompt_len, self.prefill_buckets)
        # Pages are allocated for the REAL prompt length (+1 token of
        # headroom so the decode step right after admission can always
        # write the first generated token's KV), NOT for the padded
        # prefill bucket: the bucket's padding positions write into the
        # reserved null page 0, which attention always masks. This keeps
        # page pressure proportional to actual tokens and guarantees a
        # preempted-and-regrown request can always be re-admitted.
        n_real = self._pages_needed(max(prompt_len, 1))
        n_keep = self._pages_needed(prompt_len + 1)
        if n_keep > self.alloc.free_pages:
            return False  # pool pressure: wait for a retirement
        self.waiting.popleft()
        slot_id = free[0]
        slot = self.slots[slot_id]

        toks = np.zeros((1, bucket), np.int32)
        toks[0, :prompt_len] = req.prompt
        last_logits, k_seq, v_seq = runner.prefill(
            self.params,
            jnp.asarray(toks),
            jnp.int32(prompt_len),
            self.cfg,
            use_kernel=self.use_kernel,
            arch=self.arch,
        )
        pages = self.alloc.alloc(n_keep)
        n_bucket_pages = self._pages_needed(bucket)
        write_vec = pages[:n_real] + [0] * (n_bucket_pages - n_real)
        self.pool = kvcache.write_prefill(
            self.pool, jnp.asarray(write_vec, jnp.int32), k_seq, v_seq
        )
        self._rng, key = jax.random.split(self._rng)
        first = runner.sample_one(
            last_logits, key,
            jnp.float32(req.sampling.temperature),
            jnp.int32(req.sampling.top_k),
            top_k=self.top_k, max_top_k=self.max_top_k,
        )

        slot.request = req
        slot.pages = pages
        slot.seq_len = prompt_len
        slot.last_token = 0  # unknown until processed; _tok_row covers it
        self._sched_dirty = True
        self._admit_counter += 1
        slot.admit_seq = self._admit_counter
        self._page_table[slot_id, :] = 0
        self._page_table[slot_id, : len(pages)] = pages
        self._tok_row = _scatter_token(
            self._tok_row, jnp.int32(slot_id), first
        )
        self._fresh_admit[slot_id] = (req.uid, slot.admit_seq)
        return True

    def _grow_if_needed(self, slot_id: int, ahead: int = 1) -> bool:
        """Ensure pages for positions ``seq_len .. seq_len+ahead-1`` exist
        (the next dispatch writes KV at those positions).
        Returns False if the pool runs out of pages (caller preempts)."""
        slot = self.slots[slot_id]
        page_idx = (slot.seq_len + ahead - 1) // self.page_size
        if page_idx >= self.max_pages_per_slot:
            raise MemoryError(
                f"request {slot.request.uid} exceeded max_seq_len "
                f"{self.cfg.max_seq_len}"
            )
        while len(slot.pages) <= page_idx:
            if self.alloc.free_pages < 1:
                return False
            (new_page,) = self.alloc.alloc(1)
            slot.pages.append(new_page)
            col = len(slot.pages) - 1
            self._page_table[slot_id, col] = new_page
            if self._dev is not None and col < self._dev["width"]:
                # queue a patch for the cached device table: growth within
                # the current width bucket keeps the steady-state path;
                # _dispatch applies all queued patches in one scatter
                self._table_patches.append((slot_id, col, new_page))
            else:
                self._sched_dirty = True
        return True

    def _preempt(self, slot_id: int) -> None:
        """Evict a running request under pool pressure: free its pages and
        requeue it at the head of the line with its generated tokens folded
        into the prompt, so re-admission re-prefills the full context and
        generation resumes exactly where it stopped (t_first_token and the
        max_new_tokens budget are preserved). In-flight tokens for the slot
        are dropped at processing (seat mismatch) — they were never
        delivered, and generation re-draws them after re-admission."""
        slot = self.slots[slot_id]
        req = slot.request
        req.prompt = np.concatenate(
            [np.asarray(req.prompt, np.int32),
             np.asarray(req.output, np.int32)]
        )
        self.alloc.free(slot.pages)
        self._page_table[slot_id, :] = 0
        self.slots[slot_id] = _Slot()
        self._fresh_admit.pop(slot_id, None)
        self.waiting.appendleft(req)
        self._sched_dirty = True
        self._preemptions += 1
        if self.recorder is not None:
            self.recorder.count("preemptions", 1)

    def _ensure_growth(self, slot_id: int, ahead: int = 1) -> None:
        """Backpressure instead of MemoryError: when the pool is exhausted
        mid-decode, preempt the most recently admitted *other* request until
        this slot can grow. Submit-time capacity checks guarantee progress:
        a lone request's worst-case page need always fits the pool."""
        while not self._grow_if_needed(slot_id, ahead):
            victims = [
                i
                for i, s in enumerate(self.slots)
                if s.busy and i != slot_id
            ]
            if not victims:
                raise MemoryError(
                    f"KV pool exhausted with a single active request "
                    f"(uid {self.slots[slot_id].request.uid}); this should "
                    "be impossible past the submit-time capacity check"
                )
            self._preempt(max(victims, key=lambda i: self.slots[i].admit_seq))

    def _maybe_finish(self, slot_id: int, token: int) -> bool:
        slot = self.slots[slot_id]
        req = slot.request
        done = len(req.output) >= req.max_new_tokens or (
            self.eos_id is not None and token == self.eos_id
        )
        if done:
            req.t_done = time.perf_counter()
            self.finished.append(req)
            self.alloc.free(slot.pages)
            self._page_table[slot_id, :] = 0
            self.slots[slot_id] = _Slot()
            self._fresh_admit.pop(slot_id, None)
            self._sched_dirty = True
        return done

    # ----------------------------------------------------------- step loop

    def _dispatch(self) -> int:
        """Dispatch ONE fused decode+sample window for every dispatchable
        slot, without reading the result back. Returns slots dispatched.

        A slot is dispatchable if its output budget cannot already be
        exhausted by still-unprocessed in-flight tokens (so the optimistic
        extra window never writes KV past max_seq_len). Growth for the
        positions this window writes is ensured up front, with
        pool-pressure preemption as usual; seq_len then advances
        optimistically — processing only appends tokens and retires."""
        cand = []
        for i, s in enumerate(self.slots):
            if not s.busy:
                continue
            in_flight = self._in_flight(i, s.request.uid)
            rem = s.request.max_new_tokens - len(s.request.output) - in_flight
            if rem <= 0:
                continue  # retires when the in-flight tokens are processed
            cand.append(i)
        if not cand:
            return 0
        # the window is ALWAYS multi_step tokens (one compiled program per
        # page-width bucket, nothing else): a slot whose budget ends
        # mid-window gets its overshoot trimmed at processing — submit()
        # reserved the KV headroom for exactly this
        k = self.multi_step
        # senior-first growth (covering all k window positions): under
        # pool pressure older requests preempt newer ones, never the
        # other way around
        for i in sorted(cand, key=lambda i: self.slots[i].admit_seq):
            if self.slots[i].busy:
                self._ensure_growth(i, ahead=k)
        cand = [i for i in cand if self.slots[i].busy]  # preemption culls
        if not cand:
            return 0

        # bucket the page-table width by the widest active sequence: the
        # window reads up to position seq_len+k-1, so the pool gather
        # (the decode memory-traffic floor) scales with actual lengths
        need = max(
            (self.slots[i].seq_len + k - 1) // self.page_size + 1
            for i in cand
        )
        width = next(b for b in self.decode_page_buckets if b >= need)
        self._last_decode_width = width

        ids = [(i, self.slots[i].request.uid, self.slots[i].admit_seq)
               for i in cand]
        steady = (
            not self._sched_dirty
            and self._dev is not None
            and self._dev["ids"] == ids
            and self._dev["width"] == width
            and self._dev["k"] == k
        )
        # input tokens are ALWAYS the device-resident row (admissions
        # scatter into it, windows merge into it): no host readback ever
        # gates a dispatch
        tokens_in = self._tok_row
        if steady and self._table_patches:
            p = self._table_patches
            n = 1 << max(0, len(p) - 1).bit_length()  # few compile shapes
            p = p + [p[-1]] * (n - len(p))
            self._dev["table"] = _set_pages(
                self._dev["table"],
                jnp.asarray([t[0] for t in p], jnp.int32),
                jnp.asarray([t[1] for t in p], jnp.int32),
                jnp.asarray([t[2] for t in p], jnp.int32),
            )
        # non-steady dispatches rebuild the table from the (always
        # current) host copy, superseding any queued patches
        self._table_patches.clear()
        if steady:
            # zero host->device uploads: every input is the device output
            # of the previous step or an unchanged cached array
            positions_dev = self._dev["pos"]
            table_dev = self._dev["table"]
            temps_dev = self._dev["temps"]
            topks_dev = self._dev["topks"]
            mask_dev = self._dev["mask"]
        else:
            positions = np.full((self.n_slots,), -1, np.int32)
            temps = np.zeros((self.n_slots,), np.float32)
            top_ks = np.zeros((self.n_slots,), np.int32)
            mask = np.zeros((self.n_slots,), bool)
            for i in cand:
                s = self.slots[i]
                positions[i] = s.seq_len
                temps[i] = s.request.sampling.temperature
                top_ks[i] = s.request.sampling.top_k
                mask[i] = True
            positions_dev = jnp.asarray(positions)
            table_dev = jnp.asarray(self._page_table[:, :width])
            temps_dev = jnp.asarray(temps)
            topks_dev = jnp.asarray(top_ks)
            mask_dev = jnp.asarray(mask)

        toks_seq, next_positions, self._dev_key, self.pool = (
            runner.decode_multi_step(
                self.params,
                self.pool,
                table_dev,
                positions_dev,
                tokens_in,
                self._dev_key,
                temps_dev,
                topks_dev,
                self.cfg,
                self.page_size,
                k,
                use_kernel=self.use_kernel,
                top_k=self.top_k,
                max_top_k=self.max_top_k,
                arch=self.arch,
            )
        )
        # admissions since the last dispatch ride along: their first
        # token IS this window's input row, so stack it in front and the
        # window's one readback delivers it — no per-admission round trip
        admits = []
        for i in cand:
            fa = self._fresh_admit.pop(i, None)
            s = self.slots[i]
            if fa == (s.request.uid, s.admit_seq):
                admits.append((i, fa[0], fa[1]))
        if admits:
            toks_store = jnp.concatenate([tokens_in[None], toks_seq], axis=0)
            off = 1
        else:
            toks_store, off = toks_seq, 0
        toks_store.copy_to_host_async()
        self._tok_row = _merge_rows(self._tok_row, toks_seq[-1], mask_dev)
        for i in cand:
            self.slots[i].seq_len += k
        self._dev = {
            "ids": ids,
            "width": width,
            "k": k,
            "table": table_dev,
            "pos": next_positions,
            "temps": temps_dev,
            "topks": topks_dev,
            "mask": mask_dev,
        }
        self._sched_dirty = False
        self._steps += 1
        if not self._t_first_dispatch:
            self._t_first_dispatch = time.perf_counter()
        if self.recorder is not None:
            self.recorder.count("decode_dispatches", 1)
            if steady:
                self.recorder.count("steady_steps", 1)
        self._pending.append({"ids": ids, "tokens": toks_store, "k": k,
                              "off": off, "admits": admits})
        return len(cand)

    def _process_due(self, min_batches: int = 0) -> int:
        """Read back every in-flight window beyond the pipeline depth (at
        least ``min_batches``) and do the host bookkeeping (append,
        EOS/max retire). Returns tokens kept.

        Each window's async device->host copy was started at dispatch, so
        by the time a window falls off the pipeline its tokens have
        usually landed and the readback does not wait on the device."""
        n_due = max(len(self._pending) - self.pipeline_depth, min_batches)
        n_due = min(n_due, len(self._pending))
        kept = 0
        for _ in range(n_due):
            entry = self._pending.popleft()
            t0 = time.perf_counter()
            tokens = np.asarray(entry["tokens"])  # (off + k, n_slots)
            # admissions riding this window: row 0 is the window's input
            # token row == their first generated token
            for slot_id, uid, seat in entry["admits"]:
                slot = self.slots[slot_id]
                if (slot.request is None or slot.request.uid != uid
                        or slot.admit_seq != seat):
                    continue  # preempted since: token dropped, re-drawn
                tok = int(tokens[0, slot_id])
                req = slot.request
                if not req.t_first_token:  # preserved across preemption
                    req.t_first_token = time.perf_counter()
                req.output.append(tok)
                slot.last_token = tok
                kept += 1
                self._maybe_finish(slot_id, tok)
            decoded = 0
            for t in range(entry["off"], entry["off"] + entry["k"]):
                for slot_id, uid, seat in entry["ids"]:
                    slot = self.slots[slot_id]
                    if (slot.request is None or slot.request.uid != uid
                            or slot.admit_seq != seat):
                        continue  # preempted/retired: window tail dropped
                    tok = int(tokens[t, slot_id])
                    slot.request.output.append(tok)
                    slot.last_token = tok
                    decoded += 1
                    self._maybe_finish(slot_id, tok)
            kept += decoded
            self._decode_tokens += decoded
            if self.recorder is not None:
                self.recorder.count("decode_tokens", decoded)
                self.recorder.observe(
                    "decode_step", time.perf_counter() - t0)
        if n_due:
            self._t_last_process = time.perf_counter()
        return kept

    def step(self) -> int:
        """Admit up to ``max_admits_per_step`` requests, dispatch one
        decode window, then process in-flight batches down to the pipeline
        depth. Returns the number of tokens processed (0 on pipeline-fill
        steps).

        The admission budget bounds how much device time newcomers'
        prefills can inject between decode windows in any single step;
        admission still happens every step, so free slots refill
        continuously. If no slot is decoding there is nothing to stall —
        admit until full."""
        budget = self.max_admits_per_step
        if budget is None or not any(s.busy for s in self.slots):
            budget = self.n_slots
        while budget > 0 and self._try_admit():
            budget -= 1

        dispatched = self._dispatch()
        # drain the queue down to the configured depth in ONE batched
        # readback; if nothing was dispatched this step (budgets all in
        # flight / slots idle), process at least one batch so the loop
        # always makes progress
        produced = self._process_due(
            min_batches=0 if dispatched else 1
        )
        return produced

    @property
    def _draining(self) -> bool:
        return bool(
            self.waiting
            or self._pending
            or any(s.busy for s in self.slots)
        )

    @property
    def idle(self) -> bool:
        """True when the engine has nothing queued, in flight, or seated
        (a frontend can sleep until the next arrival)."""
        return not self._draining

    def warm_widths(self, max_width_need: int,
                    max_prompt_len: Optional[int] = None) -> None:
        """Pre-compile every device program the engine can reach: the
        decode window for every page-width bucket up to and INCLUDING the
        first bucket >= ``max_width_need`` (dispatch rounds the needed
        width UP to a bucket, so stopping below it would leave the very
        program the trace runs uncompiled), and — when ``max_prompt_len``
        is given — the prefill (+KV scatter + first-token sampler) for
        every prefill bucket a prompt that long could land in. Dummy
        decode calls run with every slot inactive (positions -1), so the
        pool is untouched apart from the always-masked null page 0.
        Resets the throughput counters so a following measured trace is
        steady state."""
        zeros = jnp.zeros((self.n_slots,), jnp.int32)
        if max_prompt_len is not None:
            for b in self.prefill_buckets:
                logits, k_seq, v_seq = runner.prefill(
                    self.params, jnp.zeros((1, b), jnp.int32), jnp.int32(1),
                    self.cfg, use_kernel=self.use_kernel, arch=self.arch,
                )
                self.pool = kvcache.write_prefill(
                    self.pool,
                    jnp.zeros((self._pages_needed(b),), jnp.int32),
                    k_seq, v_seq,
                )
                runner.sample_one(
                    logits, self._rng, jnp.float32(0.0), jnp.int32(0),
                    top_k=self.top_k, max_top_k=self.max_top_k,
                )
                if b >= max_prompt_len:
                    break
        for b in self.decode_page_buckets:
            tok, _, self._dev_key, self.pool = runner.decode_multi_step(
                self.params, self.pool,
                jnp.zeros((self.n_slots, b), jnp.int32),
                zeros - 1, zeros, self._dev_key,
                jnp.zeros((self.n_slots,), jnp.float32), zeros,
                self.cfg, self.page_size, self.multi_step,
                use_kernel=self.use_kernel,
                top_k=self.top_k, max_top_k=self.max_top_k,
                arch=self.arch,
            )
            if b >= max_width_need:
                break
        jax.block_until_ready(tok)
        self._steps = 0
        self._decode_tokens = 0
        self._t_serve = 0.0
        self._t_first_dispatch = 0.0
        self._t_last_process = 0.0

    def run(self, requests: Sequence[Request]) -> List[Request]:
        """Serve a batch of requests to completion; returns them finished."""
        for r in requests:
            self.submit(r)
        t0 = time.perf_counter()
        while self._draining:
            self.step()
        self._t_serve += time.perf_counter() - t0
        return self.finished

    # ------------------------------------------------------------- metrics

    def metrics(self) -> Dict[str, float]:
        ttfts = sorted(r.ttft for r in self.finished if r.t_first_token)
        total_out = sum(len(r.output) for r in self.finished)
        # callers stepping the engine themselves (no run()) still get a
        # throughput: the first-dispatch -> last-process span
        span = self._t_serve or (
            self._t_last_process - self._t_first_dispatch
            if self._t_last_process > self._t_first_dispatch else 0.0
        )
        m = {
            "requests_finished": len(self.finished),
            "output_tokens": total_out,
            "decode_steps": self._steps,
            "serve_seconds": round(span, 4),
            "throughput_tok_s": round(total_out / span, 1) if span else 0.0,
            "pool_pages_free": self.alloc.free_pages,
            "preemptions": self._preemptions,
        }
        if ttfts:
            m["ttft_p50_ms"] = round(1e3 * ttfts[len(ttfts) // 2], 2)
            m["ttft_p99_ms"] = round(
                1e3 * ttfts[min(len(ttfts) - 1, int(len(ttfts) * 0.99))], 2
            )
        if self.recorder is not None:
            m.update(self.recorder.snapshot())
        return m
