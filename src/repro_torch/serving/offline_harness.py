"""MLPerf-offline-style serving harness over the slab KV pool: batched
prefill/decode with ONE dispatch per decode tick.

The port of ``repro/serving/offline_harness.py``. The same open-loop
request stream (arrival timestamps, mixed prompt/output lengths, tenant
tags) runs through the same host bookkeeping (admission, class-overflow
reallocation, completion, observe/arbitrate/refit — carried over
verbatim), and the device work of a decode tick goes through the port's
hand-written kernels:

* pending class-overflow chunk moves as two ``ops.kv_chunk_copy`` calls
  (k and v pools), ``ops.slab_decode_attention`` straight over the slab
  pools, an argmax for the next token, and two ``ops.kv_append`` calls
  landing the new tokens' KV rows;
* on the card, ``mode="batched"`` captures that tick ONCE per harness as
  a CUDA graph over static ``max_batch``-shaped buffers: each tick copies
  its slot state into the buffers and replays the graph, so a decode
  tick is one dispatch (``n_decode_dispatches`` counts replays; the
  kernels' launch counters count their wrappers' calls only, so a
  replay does not advance them);
* ``mode="legacy"`` runs the same step eagerly, one request at a time:
  the bit-parity oracle. Every kernel computes each sequence on its own
  (the attention kernel's work split never depends on the batch), so
  tokens and every decision are bit-identical between the modes;
* on the CPU (``torch_device="cpu"``) both modes run the step eagerly
  through the kernels' plain versions.

Prefill writes each newly admitted prompt's KV with plain PyTorch (the
reference does it with ``dynamic_update_slice``, not a kernel), one call
per tick in batched mode. Tokens stay on the device until
:meth:`OfflineHarness.result` reads them back once.

The toy model is deterministic by construction: KV/Q content are
elementwise uint32 hashes of (request id, position, token), computed in
int64 with every product and sum masked to 32 bits, so they wrap exactly
as the reference's uint32 arithmetic does; the next token is an argmax
(ties break low) over a slice of the attention output.

Junk-range contract: the device pools are padded ``max_chunk_tokens``
past ``pool_tokens`` so the scatter kernels' reserved tail can never
alias a real allocation.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.guards import deliberate_sync
from repro_torch.analysis.registry import hot_path
from repro_torch.kernels import ops
from repro_torch.serving.kv_slab_pool import ALIGN, KVSlabPool
from repro_torch.serving.scheduler import Request, queue_delay_stats

_M32 = 0xFFFFFFFF


# -- deterministic toy model ---------------------------------------------------
# uint32 hashes in int64: every product and sum is masked back to 32 bits,
# so the low bits wrap exactly as the reference's uint32 ops do (an int64
# product that overflows still has the right low 32 bits). The only float
# ops are one convert and one multiply-add per element (IEEE-exact).

def _u32(x: torch.Tensor) -> torch.Tensor:
    """``x`` as uint32 values held in int64 (a float converts by
    truncation, as the reference's ``astype(uint32)`` does)."""
    return x.to(torch.int64) & _M32


def _mix(rid, pos, token, salt: int, hkv: int, d: int) -> torch.Tensor:
    """(..., hkv, d) uint32 hash (in int64) of (request id, position,
    token)."""
    dev = rid.device
    rid = _u32(rid)[..., None, None]
    pos = _u32(pos)[..., None, None]
    token = _u32(token)[..., None, None]
    h = torch.arange(hkv, dtype=torch.int64, device=dev)[:, None]
    dd = torch.arange(d, dtype=torch.int64, device=dev)[None, :]
    x = (rid * 2654435761) & _M32
    x = (x + ((pos * 40503) & _M32)) & _M32
    x = (x + ((token * 69069) & _M32)) & _M32
    x = (x + ((h * 97) & _M32)) & _M32
    x = (x + ((dd * 131) & _M32)) & _M32
    x = (x + salt) & _M32
    x = x ^ (x >> 15)
    x = (x * 2246822519) & _M32
    x = x ^ (x >> 13)
    return x


def _to_unit(x: torch.Tensor) -> torch.Tensor:
    """uint32 hash -> float32 in [-1, 1), one convert + one fma."""
    return (x & 0xFFFF).to(torch.float32) / 32768.0 - 1.0


def _kv_content(rid, pos, token, hkv: int, d: int):
    return (_to_unit(_mix(rid, pos, token, 0x9E37, hkv, d)),
            _to_unit(_mix(rid, pos, token, 0x85EB, hkv, d)))


def _q_content(rid, pos, hkv: int, d: int) -> torch.Tensor:
    return _to_unit(_mix(rid, pos, torch.zeros_like(rid), 0xC2B2, hkv, d))


@dataclasses.dataclass
class HarnessResult:
    """One offline run's ledger. ``tokens`` maps request id → generated
    token ids (the parity surface: batched vs legacy must match
    bit-for-bit); dispatch counters are the O(ticks) contract."""
    ticks: int
    completed: int
    rejected: int
    realloc_copies: int
    realloc_tokens: int
    generated_tokens: int
    n_decode_dispatches: int
    n_prefill_dispatches: int
    queue_delay_mean: float
    queue_delay_p50: float
    queue_delay_p99: float
    mean_waste_fraction: float
    peak_active: int
    mean_active: float
    n_refits: int
    n_admission_denials: int
    tokens: Dict[int, List[int]]

    def decisions(self) -> tuple:
        """The admission/progress decision fingerprint two runs must
        share to count as identical (tokens compared separately)."""
        return (self.ticks, self.completed, self.rejected,
                self.realloc_copies, self.realloc_tokens,
                self.n_refits, self.n_admission_denials)


class OfflineHarness:
    """Open-loop offline serving over a :class:`KVSlabPool`.

    ``mode="batched"`` — one decode dispatch per tick for the whole
    active batch (a CUDA-graph replay on the card), and one prefill call
    per tick with admissions. ``mode="legacy"`` — identical host
    bookkeeping, one eager step per request: the bit-parity oracle.

    The harness owns float32 device pools shaped
    ``(pool_tokens_padded, hkv, d)`` on ``torch_device`` (default
    ``"cuda"``; raises without a card); ``pool`` supplies allocation
    decisions only. Chunk classes may refit DOWN or re-partition freely
    mid-run (``adaptive=True``), but growing the top class past the
    harness's ``max_chunk_tokens`` ceiling raises — the static shapes of
    the captured step cannot stretch.

    Admission: FIFO over arrivals; with an ``arbiter``, each candidate
    first passes ``TenantArbiter.admission`` (tick-granular gate,
    denials recorded as tenant pressure), then the pool's own
    quota/capacity check. Gate or alloc failure rejects (drops) the
    request — the ContinuousBatcher contract.
    """

    def __init__(self, pool: KVSlabPool, *, max_batch: int = 64,
                 mode: str = "batched", hkv: int = 1, d: int = 16,
                 vocab: int = 16, max_chunk_tokens: Optional[int] = None,
                 adaptive: bool = False, arbiter=None, torch_device="cuda"):
        if mode not in ("batched", "legacy"):
            raise ValueError(f"unknown mode {mode!r}")
        if vocab > d:
            raise ValueError(f"vocab {vocab} > head dim {d}")
        self.device = ops.resolve_device(torch_device)
        self.pool = pool
        self.mode = mode
        self.max_batch = int(max_batch)
        self.adaptive = adaptive
        self.arbiter = arbiter
        self.vocab = int(vocab)
        self.max_chunk = int(max_chunk_tokens or pool.max_chunk_tokens)
        if self.max_chunk % ALIGN:
            raise ValueError(f"max_chunk_tokens must be a multiple "
                             f"of {ALIGN}")
        # device pools: pad past pool_tokens so the scatter kernels'
        # reserved tail range is never a real allocation (junk-range
        # contract), and keep rows a multiple of ALIGN for tile copies
        t_pad = -(-pool.pool_tokens // ALIGN) * ALIGN + self.max_chunk
        self._k = torch.zeros((t_pad, hkv, d), dtype=torch.float32,
                              device=self.device)
        self._v = torch.zeros_like(self._k)
        # fixed-size slot state (one captured shape per run)
        self._starts = np.zeros(self.max_batch, np.int32)
        self._lens = np.zeros(self.max_batch, np.int32)
        self._rids = np.zeros(self.max_batch, np.int32)
        self._act = np.zeros(self.max_batch, np.int32)
        self._free_slots = list(range(self.max_batch - 1, -1, -1))
        self._slot_of: Dict[int, int] = {}
        self._queue: Deque[Request] = deque()
        self._active: Dict[int, Request] = {}
        # batched decode on the card: static inputs (starts, lens, rids,
        # active, move src, move dst, move tokens), the captured graph
        # and its token output
        self._inputs: Optional[torch.Tensor] = None
        self._graph = None
        self._graph_tokens: Optional[torch.Tensor] = None
        self.capture_s = 0.0    # host seconds the capture took
        # ledger
        self.completed = 0
        self.rejected = 0
        self.realloc_copies = 0
        self.realloc_tokens = 0
        self.n_refits = 0
        self.n_decode_dispatches = 0
        self.n_prefill_dispatches = 0
        self.queue_delays: List[float] = []
        # (slot→rid snapshot, device tokens) per decode dispatch; read
        # back to host ONCE in result()
        self._token_log: List[Tuple[Tuple[Optional[int], ...],
                                    torch.Tensor]] = []

    def submit(self, req: Request) -> None:
        if req.tenant not in self.pool._tenants:
            self.pool.register_tenant(req.tenant)
        self._queue.append(req)

    # -- host bookkeeping phases (shared verbatim by both modes) -------------
    def _admit_phase(self, t: int, observed: List[int]
                     ) -> List[Tuple[int, int, int, int]]:
        """FIFO admission under arrivals/slots/gate/quota; returns the
        prefill plan ``[(slot, start, prompt_len, rid), ...]`` in
        admission order."""
        plan: List[Tuple[int, int, int, int]] = []
        while (self._queue and self._queue[0].arrival <= t
                and self._free_slots):
            req = self._queue[0]
            # observed BEFORE the attempt (ContinuousBatcher contract)
            observed.append(req.kv_len)
            if self.arbiter is not None:
                chunk = self.pool.class_for(req.kv_len)
                if chunk is not None:
                    units = -(-chunk // self.arbiter.pool.unit_size)
                    if not self.arbiter.admission(req.tenant, units):
                        self.rejected += 1
                        self._queue.popleft()
                        continue
            a = self.pool.alloc(req.rid, req.kv_len, tenant=req.tenant)
            if a is None:
                self.rejected += 1
                self._queue.popleft()
                continue
            self._queue.popleft()
            slot = self._free_slots.pop()
            self._slot_of[req.rid] = slot
            self._active[req.rid] = req
            self._starts[slot] = a.start
            self._lens[slot] = req.kv_len
            self._rids[slot] = req.rid
            self._act[slot] = 1
            self.queue_delays.append(t - req.arrival)
            plan.append((slot, a.start, req.prompt_len, req.rid))
        return plan

    def _decode_phase(self, observed: List[int]
                      ) -> Tuple[List[Tuple[int, int, int, int]],
                                 List[int]]:
        """Per-tick decode bookkeeping: growth (bulk), class-overflow
        reallocation (inline, processing order), completion/drop
        marking. Returns ``(plan, finished)`` where plan rows are
        ``(slot, mv_src, mv_dst, mv_tok)`` (move tokens 0 = no move)
        and ``finished`` lists drops and completions in processing
        order (freelist order is part of the decision contract)."""
        plan: List[Tuple[int, int, int, int]] = []
        grown: List[Tuple[int, int]] = []
        finished: List[int] = []
        for rid, req in self._active.items():
            slot = self._slot_of[rid]
            req.decoded += 1
            old = self.pool.allocation(rid)
            pre_len = req.kv_len - 1
            mv = (0, 0, 0)
            if req.kv_len <= old.chunk:
                grown.append((rid, req.kv_len))
                start = old.start
            else:
                new = self.pool.extend(rid, req.kv_len)
                if new is None:   # pool full mid-flight: drop, no decode
                    observed.append(req.kv_len)
                    self.rejected += 1
                    finished.append(rid)
                    self._act[slot] = 0
                    continue
                if new.start != old.start:
                    self.realloc_copies += 1
                    self.realloc_tokens += old.length
                    observed.append(req.kv_len)
                    mv = (old.start, new.start, old.length)
                start = new.start
            self._starts[slot] = start
            self._lens[slot] = pre_len
            plan.append((slot, *mv))
            if req.decoded >= req.output_len:
                finished.append(rid)
                self.completed += 1
        if grown:
            self.pool.extend_bulk(grown)
        return plan, finished

    def _release(self, rids: List[int]) -> None:
        for rid in rids:
            if rid in self.pool._live:
                self.pool.free(rid)
            del self._active[rid]
            slot = self._slot_of.pop(rid)
            self._act[slot] = 0
            self._free_slots.append(slot)

    # -- device work -----------------------------------------------------------
    def _decode_step(self, starts, lens, rids, active, mv_src, mv_dst,
                     mv_tok) -> torch.Tensor:
        """One decode step over the slots given (int32 tensors on the
        harness's device), updating the pools in place; returns the
        slots' next tokens (-1 for inactive slots)."""
        k, v = self._k, self._v
        hkv, d = k.shape[1], k.shape[2]
        # 1) pending class-overflow chunk moves (array order = the
        #    allocator's processing order; WAR-safe, see kv_scatter)
        ops.kv_chunk_copy(k, mv_src, mv_dst, mv_tok,
                          max_copy_tokens=self.max_chunk)
        ops.kv_chunk_copy(v, mv_src, mv_dst, mv_tok,
                          max_copy_tokens=self.max_chunk)
        # 2) flash-decode over the pool for the whole batch
        q = _q_content(rids, lens, hkv, d)
        live = active > 0
        alens = torch.where(live, lens, 0).to(torch.int32)
        out = ops.slab_decode_attention(q, k, v, starts, alens,
                                        max_chunk_tokens=self.max_chunk)
        # 3) next token: argmax over a slice of the attention output —
        #    per-row, no cross-batch mixing, ties break low
        tokens = torch.argmax(out[:, 0, :self.vocab], dim=-1)
        tokens = torch.where(live, tokens, -1).to(torch.int32)
        # 4) append the new token's KV row at position lens
        kc, vc = _kv_content(rids, lens, tokens.clamp(min=0), hkv, d)
        rows = torch.where(live, starts + lens, -1).to(torch.int32)
        ops.kv_append(k, rows, kc.contiguous())
        ops.kv_append(v, rows, vc.contiguous())
        return tokens

    def _capture(self) -> None:
        """Capture the batched decode step once as a CUDA graph over the
        static input buffer. A warm-up run on a side stream first (all
        slots inactive: it writes nothing) loads every kernel."""
        t0 = time.perf_counter()
        self._inputs = torch.zeros((7, self.max_batch), dtype=torch.int32,
                                   device=self.device)
        stream = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            self._decode_step(*self._inputs)
        stream.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._graph_tokens = self._decode_step(*self._inputs)
        self._graph = graph
        self.capture_s = time.perf_counter() - t0

    def _dispatch_prefill(self, plan) -> None:
        if not plan:
            return
        groups = [plan] if self.mode == "batched" else [[p] for p in plan]
        for group in groups:
            self._prefill(group)
            self.n_prefill_dispatches += 1

    def _prefill(self, group) -> None:
        """Write every planned prompt's KV rows: position p of request
        rid gets the content of token ``p % vocab`` (the request id goes
        through float32 first, as the reference's prefill builds it)."""
        rows = np.concatenate([start + np.arange(plen, dtype=np.int64)
                               for _slot, start, plen, _rid in group])
        if rows.size == 0:
            return
        pos = np.concatenate([np.arange(plen, dtype=np.int64)
                              for _slot, _start, plen, _rid in group])
        rid = np.concatenate([np.full(plen, rid, dtype=np.float32)
                              for _slot, _start, plen, rid in group])
        dev = self.device
        pos_t = torch.from_numpy(pos).to(dev)
        kc, vc = _kv_content(torch.from_numpy(rid).to(dev), pos_t,
                             pos_t % self.vocab, self._k.shape[1],
                             self._k.shape[2])
        rows_t = torch.from_numpy(rows).to(dev)
        self._k[rows_t] = kc
        self._v[rows_t] = vc

    def _dispatch_decode(self, plan) -> None:
        if not plan:
            return
        if self.mode == "batched":
            moves = np.zeros((3, self.max_batch), np.int32)
            n_mv = 0
            for _slot, src, dst, tok in plan:
                if tok:
                    moves[:, n_mv] = (src, dst, tok)
                    n_mv += 1
            packed = np.concatenate([np.stack([self._starts, self._lens,
                                               self._rids, self._act]),
                                     moves])
            host = torch.from_numpy(packed)
            if self.device.type == "cuda":
                if self._graph is None:
                    self._capture()
                # pinned staging: the copy is queued without waiting for
                # the card, and the host buffer is not reused until the
                # copy has run
                self._inputs.copy_(host.pin_memory(), non_blocking=True)
                self._graph.replay()
                tokens = self._graph_tokens.clone()
            else:
                tokens = self._decode_step(*host)
            self.n_decode_dispatches += 1
            snap = tuple(int(self._rids[s]) if self._act[s] else None
                         for s in range(self.max_batch))
            self._token_log.append((snap, tokens))
            return
        for slot, src, dst, tok in plan:
            one = np.asarray([self._starts[slot], self._lens[slot],
                              self._rids[slot], self._act[slot], src, dst,
                              tok], dtype=np.int32)[:, None]
            tokens = self._decode_step(
                *torch.from_numpy(one).to(self.device))
            self.n_decode_dispatches += 1
            self._token_log.append(((int(self._rids[slot]),), tokens))

    # -- the tick -------------------------------------------------------------
    @hot_path(counters=("n_decode_dispatches", "n_prefill_dispatches"))
    def tick(self, t: int) -> None:
        """One serving tick: admit → prefill dispatch → decode
        bookkeeping → ONE decode dispatch (batched mode) → frees →
        observe/arbitrate/refit. No device value is synced to host
        here — tokens stay on device until :meth:`result`."""
        observed: List[int] = []
        prefill_plan = self._admit_phase(t, observed)
        self._dispatch_prefill(prefill_plan)
        decode_plan, finished = self._decode_phase(observed)
        self._dispatch_decode(decode_plan)
        self._release(finished)
        if self.pool.batch_observe and observed:
            self.pool.observe_lengths(np.asarray(observed, dtype=np.int64))
        if self.arbiter is not None:
            self.arbiter.tick(1)
        if self.adaptive:
            decision = self.pool.maybe_refit()
            if decision is not None and decision.approved:
                self.n_refits += 1
                if self.pool.max_chunk_tokens > self.max_chunk:
                    raise RuntimeError(
                        f"refit grew the top class to "
                        f"{self.pool.max_chunk_tokens} tokens, past the "
                        f"harness's ceiling {self.max_chunk}; "
                        f"construct the harness with max_chunk_tokens= "
                        f"headroom for adaptive runs")

    def run(self, workload: List[Request],
            max_ticks: Optional[int] = None) -> HarnessResult:
        for req in sorted(workload, key=lambda r: r.arrival):
            self.submit(req)
        if max_ticks is None:
            horizon = max((int(r.arrival) for r in workload), default=0)
            max_ticks = horizon + sum(r.output_len for r in workload) + 16
        waste_samples: List[float] = []
        active_samples: List[int] = []
        t = -1
        for t in range(max_ticks):
            self.tick(t)
            st = self.pool.stats()
            if st.active_requests:
                waste_samples.append(st.waste_fraction)
            active_samples.append(st.active_requests)
            if not self._active and not self._queue:
                break
        return self.result(t + 1, waste_samples, active_samples)

    def result(self, ticks: int, waste_samples=(), active_samples=(0,)
               ) -> HarnessResult:
        """Fold the run's ledger (reading the device token log back to
        host exactly once)."""
        tokens: Dict[int, List[int]] = {}
        if self._token_log:
            flat = torch.cat([dev for _, dev in self._token_log])
            with deliberate_sync("OfflineHarness.result-tokens"):
                flat = flat.cpu().numpy()
            at = 0
            for snap, _ in self._token_log:
                arr = flat[at:at + len(snap)]
                at += len(snap)
                for slot, rid in enumerate(snap):
                    if rid is not None and arr[slot] >= 0:
                        tokens.setdefault(rid, []).append(int(arr[slot]))
        qd_mean, qd_p50, qd_p99 = queue_delay_stats(self.queue_delays)
        denials = (self.arbiter.n_admission_denials
                   if self.arbiter is not None else 0)
        return HarnessResult(
            ticks=ticks,
            completed=self.completed,
            rejected=self.rejected,
            realloc_copies=self.realloc_copies,
            realloc_tokens=self.realloc_tokens,
            generated_tokens=sum(len(v) for v in tokens.values()),
            n_decode_dispatches=self.n_decode_dispatches,
            n_prefill_dispatches=self.n_prefill_dispatches,
            queue_delay_mean=qd_mean,
            queue_delay_p50=qd_p50,
            queue_delay_p99=qd_p99,
            mean_waste_fraction=(float(np.mean(waste_samples))
                                 if len(waste_samples) else 0.0),
            peak_active=int(np.max(active_samples)),
            mean_active=float(np.mean(active_samples)),
            n_refits=self.n_refits,
            n_admission_denials=denials,
            tokens=tokens)
