"""Continuous-batching serving engine over a paged K/V pool (PyTorch port of
`sea_tpu/serving/engine.py`).

* **One step shape.** Every engine step feeds each active slot exactly one
  token: its next prompt token while prefilling, or its last sampled token
  once generating. Prompt ingestion is thereby batched with decode, and the
  engine runs one step of fixed shape (max_slots rows) forever. SEA's decode
  state advances token by token (the CNN window), so token-at-a-time
  prefill is also the exact path.
* **Paged K/V.** K/V live in per-layer page pools (L, P, page_size, H, D) on
  the device; a sequence owns an ordered list of page ids (position-major,
  shared by all layers). Finished requests return their pages to a host-side
  free list, so sequences of any length share one fixed footprint. Page 0 is
  a reserved dummy: unallocated tail pages and idle slots point at it, and
  the length-derived row mask keeps it out of every softmax.
* **Per-slot positions.** The decode states' counters are (S,) tensors, and
  `SeaAttention._decode_common` is per row, so slots at different positions
  decode in one step. Slots that cannot be scheduled (waiting on a free
  page) are frozen by `select_state_rows`.

Scheduling: first come, first served admission to free slots; a slot stalls
(keeps its state, burns one lane) when the pool has no free page at a page
boundary, and resumes when another request completes. Sampling is per slot:
greedy (temperature 0) or temperature / top-k / top-p
(`ops.sampling.sample_logits`); when every scheduled request is unfiltered
the step skips the (S, V) sort.

`step(chunk)` runs `chunk` decode steps on the device between two host syncs:
one upload of the chunk's inputs and one (chunk, S) download of its tokens.

`dtype` is the type of the K/V pools and of the decode states' CNN
window (JAX's `dtype=`, float32 by default); the states' FAVOR+ sums and
running sum of v stay float32 whatever it is. A bfloat16 engine over a
model cast to bfloat16 decodes in bfloat16 throughout. (Over float32
parameters the windows promote to float32 after the first step, as JAX's
concatenation promotes them; JAX's engine refuses that pairing, its scan
carry changing type.)

`mesh=` (a `Mesh` and its `head_axis`, or a shard group) serves a
tensor-parallel model (`parallel.tp.tensor_parallel` over the same group)
with the pools (L, P, page_size, H, D) and each decode state's per-head
leaves (`models.state.HEAD_FIELDS`) split over the group's positions by
head: each position keeps its own heads' pools and states, decodes them,
and the output projection ends in the sum
(`parallel.tp.tp_decode_step_paged`). The estimator mixes heads, so every
step gathers the CNN windows. The same requests give the unsharded
engine's tokens.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.opt import CausalLMGeneration
from ..models.state import SeaDecodeState, head_shard, reset_state_rows, select_state_rows
from ..ops.sampling import sample_logits
from ..parallel.mesh import Mesh
from ..parallel.tp import tp_decode_step_paged


@dataclasses.dataclass
class Request:
    """One generation request and its bookkeeping."""

    prompt: List[int]
    max_new_tokens: int
    temperature: float = 0.0
    top_k: int = 0  # 0 disables
    top_p: float = 1.0  # 1.0 disables
    # --- owned by the engine ---
    rid: int = -1
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    truncated: bool = False


class PageAllocator:
    """Host-side free list over pool pages 1..num_pages-1 (0 is the dummy)."""

    def __init__(self, num_pages: int):
        self.free: List[int] = list(range(num_pages - 1, 0, -1))

    def alloc(self) -> Optional[int]:
        return self.free.pop() if self.free else None

    def release(self, pages: List[int]) -> None:
        self.free.extend(p for p in pages if p > 0)

    @property
    def available(self) -> int:
        return len(self.free)


class ServingEngine:
    """Continuous-batching generation over a causal SEA model with the
    decode cache (`sea.use_cache`): `OptForCausalLM`, or `LlamaForCausalLM`,
    whose per-slot positions drive its RoPE, the pools holding its roped
    keys expanded to `num_heads` (GQA included). The engine reads only the
    model's `cfg`, `device`, `init_decode_states` and `decode_step_paged`.

    max_slots: sequences decoded per step.
    page_size: tokens per K/V page.
    num_pages: pool pages per layer, the dummy page 0 included; the pools
        take 2 · L · num_pages · page_size · H · D elements.
    max_pages_per_slot: the page table's width, so a sequence holds at most
        max_pages_per_slot · page_size tokens.
    eos_id: a sampled token that ends its request.
    seed: seeds the sampler's generator; step i of the engine's life takes
        the generator's i-th (S, V) block of Gumbel noise.
    dtype: the pools' and the CNN windows' type.
    device: where the pools and states live; the model must be there.
    mesh, head_axis: head-sharded serving over `mesh`'s `head_axis` group
        (or `mesh` a group itself); the model must be tensor parallel over
        that group, and the group's size must divide num_heads. The pools
        and states are then lists, one entry per held position.
    """

    def __init__(
        self,
        model: CausalLMGeneration,
        *,
        max_slots: int = 4,
        page_size: int = 16,
        num_pages: int = 64,
        max_pages_per_slot: int = 8,
        eos_id: Optional[int] = None,
        seed: int = 0,
        dtype=torch.float32,
        device="cuda",
        mesh=None,
        head_axis: str = "tp",
    ):
        device = torch.device(device)
        if model.device.type != device.type:
            raise ValueError(f"the model is on {model.device}, the engine on {device}")
        cfg = model.cfg
        self.model = model
        self.device = device
        self.max_slots = max_slots
        self.page_size = page_size
        self.max_pages = max_pages_per_slot
        self.max_len = page_size * max_pages_per_slot
        self.eos_id = eos_id
        S = max_slots
        L = cfg.num_layers
        H, D = cfg.sea.num_heads, cfg.sea.head_dim

        self.allocator = PageAllocator(num_pages)
        self.pages_np = np.zeros((S, self.max_pages), np.int64)

        # per-layer states with zero-width contiguous caches and (S,) per-slot
        # counters
        def per_slot(st: SeaDecodeState) -> SeaDecodeState:
            z = torch.zeros((S,), dtype=torch.int32, device=device)
            return st._replace(length=z, cnn_filled=z, cumavg_len=z)

        states = [per_slot(st) for st in model.init_decode_states(S, 0, dtype)]
        self.group = None
        if mesh is None:
            self.pool_k = torch.zeros((L, num_pages, page_size, H, D), dtype=dtype,
                                      device=device)
            self.pool_v = torch.zeros_like(self.pool_k)
            self.states = states
        else:
            group = mesh.group(head_axis) if isinstance(mesh, Mesh) else mesh
            if H % group.size:
                raise ValueError(f"{H} heads do not split over {group.size} positions")
            if getattr(model, "tp_group", None) is not group:
                raise ValueError("a head-sharded engine serves a model made tensor parallel "
                                 "over its group (parallel.tp.tensor_parallel)")
            self.group = group
            n = group.size
            # one entry per held position: its heads' pools and states
            self.pool_k = [torch.zeros((L, num_pages, page_size, H // n, D), dtype=dtype,
                                       device=device) for _ in group.positions]
            self.pool_v = [torch.zeros_like(pk) for pk in self.pool_k]
            self.states = [[head_shard(st, n, p) for st in states] for p in group.positions]

        self._generator = torch.Generator(device).manual_seed(seed)
        self._rid = 0
        self.queue: List[Request] = []
        self.slots: List[Optional[Request]] = [None] * S
        self.slot_pos = np.zeros(S, np.int64)  # tokens fed so far
        self.slot_pages: List[List[int]] = [[] for _ in range(S)]
        self.finished: Dict[int, Request] = {}

    # ------------------------------------------------------------------
    def _upload(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(x).to(self.device)

    @torch.no_grad()
    def _run_chunk(self, fed, use_fed, start_pos, sched, pages, temps, top_ks, top_ps,
                   use_filter: bool) -> torch.Tensor:
        """C = fed.shape[0] decode steps on the device: inner step i feeds
        each slot its prompt token (use_fed) or the previous step's sample,
        so prefill streams through the same loop. Unscheduled slots keep
        their states (their K/V writes land on their next position, or on
        the dummy page). Returns the (C, S) tokens, on the device."""
        C, S = fed.shape
        last = torch.zeros((S,), dtype=torch.int64, device=self.device)
        toks = []
        for i in range(C):
            tok = torch.where(use_fed[i], fed[i], last)[:, None]
            if self.group is None:
                logits, new_states, self.pool_k, self.pool_v = self.model.decode_step_paged(
                    tok, start_pos + i, self.states, self.pool_k, self.pool_v, pages)
            else:
                logits, new_states = tp_decode_step_paged(
                    self.model, tok, start_pos + i, self.states, self.pool_k, self.pool_v, pages)
            # with every request unfiltered, constant filters skip the (S, V) sort
            last = sample_logits(logits[:, 0], temps, top_ks if use_filter else 0,
                                 top_ps if use_filter else 1.0, generator=self._generator)
            self.states = self._map_states(lambda os_, ns: select_state_rows(ns, os_, sched),
                                           new_states)
            toks.append(last)
        return torch.stack(toks)

    # ------------------------------------------------------------------
    def submit(self, prompt: List[int], max_new_tokens: int = 16, temperature: float = 0.0,
               top_k: int = 0, top_p: float = 1.0) -> int:
        if len(prompt) < 1:
            raise ValueError("empty prompt")
        req = Request(list(prompt), max_new_tokens, temperature, top_k, top_p)
        req.rid = self._rid
        self._rid += 1
        self.queue.append(req)
        return req.rid

    def _admit(self) -> None:
        reset_rows = np.zeros(self.max_slots, bool)
        for s in range(self.max_slots):
            if not self.queue:
                break
            if self.slots[s] is not None:
                continue
            if self.allocator.available == 0:
                break
            self.slots[s] = self.queue.pop(0)
            self.slot_pos[s] = 0
            self.slot_pages[s] = []
            self.pages_np[s] = 0
            reset_rows[s] = True
        if reset_rows.any():
            rows = self._upload(reset_rows)
            self.states = self._map_states(lambda st, _: reset_state_rows(st, rows))

    def _map_states(self, fn, others=None):
        """`fn(state, other)` on every layer's state (each held position's,
        when head-sharded), `other` the matching entry of `others`."""
        if self.group is None:
            return [fn(st, o) for st, o in zip(self.states, others or self.states)]
        return [[fn(st, o) for st, o in zip(sts, os_)]
                for sts, os_ in zip(self.states, others or self.states)]

    def _finish(self, s: int, truncated: bool = False) -> None:
        req = self.slots[s]
        req.done = True
        req.truncated = truncated
        self.finished[req.rid] = req
        self.allocator.release(self.slot_pages[s])
        self.slot_pages[s] = []
        self.pages_np[s] = 0
        self.slots[s] = None

    # ------------------------------------------------------------------
    def step(self, chunk: int = 1) -> None:
        """One engine iteration of `chunk` decode steps: admit, allocate each
        scheduled slot's pages for the whole chunk, run the steps, replay the
        (chunk, S) sampled tokens on the host, retire finished requests.

        Larger chunks spread the host round trip over more tokens, at the
        cost of coarser admission and EOS: a slot that ends mid-chunk decodes
        on for the rest of it, and the replay drops those tokens."""
        self._admit()
        S, C = self.max_slots, chunk
        fed = np.zeros((C, S), np.int64)
        use_fed = np.zeros((C, S), bool)
        start_pos = np.zeros(S, np.int32)
        sched = np.zeros(S, bool)
        temps = np.zeros(S, np.float32)
        top_ks = np.zeros(S, np.int64)
        top_ps = np.ones(S, np.float32)

        for s, req in enumerate(self.slots):
            if req is None:
                continue
            pos = int(self.slot_pos[s])
            if pos >= self.max_len:
                self._finish(s, truncated=True)
                continue
            # pages covering [pos, min(pos + C, max_len)) must exist up front
            last_needed = (min(pos + C, self.max_len) - 1) // self.page_size
            ok = True
            while len(self.slot_pages[s]) <= last_needed:
                pg = self.allocator.alloc()
                if pg is None:
                    ok = False  # the whole chunk stalls; the state stays frozen
                    break
                self.pages_np[s, len(self.slot_pages[s])] = pg
                self.slot_pages[s].append(pg)
            if not ok:
                continue
            start_pos[s] = pos
            sched[s] = True
            temps[s] = req.temperature
            top_ks[s] = req.top_k
            top_ps[s] = req.top_p
            for i in range(C):
                p = pos + i
                if p < len(req.prompt):
                    fed[i, s] = req.prompt[p]
                    use_fed[i, s] = True
                elif i == 0:
                    # a chunk that opens mid-decode: feed the last token
                    # sampled in the chunk before
                    fed[0, s] = req.output[-1]
                    use_fed[0, s] = True

        if not sched.any():
            return
        # a dummy tail column: chunk positions past capacity land on page 0
        pages_t = np.concatenate([self.pages_np, np.zeros((S, 1), np.int64)], axis=1)
        use_filter = bool(top_ks.any() or (top_ps < 1.0).any())
        toks = self._run_chunk(
            self._upload(fed), self._upload(use_fed), self._upload(start_pos),
            self._upload(sched), self._upload(pages_t), self._upload(temps),
            self._upload(top_ks), self._upload(top_ps), use_filter,
        )
        toks = toks.cpu().numpy()  # (C, S)

        for s in range(S):
            req = self.slots[s]
            if req is None or not sched[s]:
                continue
            finished = False
            for i in range(C):
                pos = int(start_pos[s]) + i
                # the step that consumed the last prompt token emits the
                # first generated token; earlier prefill samples are dropped
                if pos >= len(req.prompt) - 1:
                    tok = int(toks[i, s])
                    req.output.append(tok)
                    if (self.eos_id is not None and tok == self.eos_id) or (
                            len(req.output) >= req.max_new_tokens):
                        self._finish(s)
                        finished = True
                        break
                if pos + 1 >= self.max_len:
                    self._finish(s, truncated=True)
                    finished = True
                    break
            if not finished:
                self.slot_pos[s] = int(start_pos[s]) + C

    # ------------------------------------------------------------------
    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slots)

    def run(self, max_steps: int = 10_000, chunk: int = 1) -> Dict[int, Request]:
        """Step until every submitted request finishes (or `max_steps`)."""
        steps = 0
        while self.has_work and steps < max_steps:
            self.step(chunk)
            steps += 1
            if not any(r is not None for r in self.slots) and (
                    self.queue and self.allocator.available == 0):
                raise RuntimeError("deadlock: queued requests but no pages free")
        return dict(self.finished)
