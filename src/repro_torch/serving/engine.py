"""Batched LM serving engine: prefill + greedy/temperature decode.

Counterpart of ``repro.serving.engine``. A single-process continuous-batching
core: requests are padded into a fixed batch, prefilled token by token
through ``decode_step`` (uniform code path — no separate prefill graph to
keep per-request state simple), then decoded until EOS/max_tokens. Per-slot
state lives in the model's KV caches; the queue/slot-refill bookkeeping is
:class:`~repro_torch.serving.batcher.SlotScheduler`, and per-step occupancy
plus per-request latency land in a
:class:`~repro_torch.serving.metrics.ServingMetrics`. Sampling runs in numpy
on the host, on the step's float32 logits.

The engine runs on ``"cuda"`` unless the caller passes ``device="cpu"``
(the plain versions of the kernels), and raises when no card is present;
the parameters must lie on that device.

``generate(requests, workers=N)`` runs N concurrent decode loops in threads,
each with its *own* KV caches, slot pool, sampling RNG
(``default_rng((seed, i))``) and, on the card, its own CUDA stream, all
sharing the one parameter set and the one metrics instance
(``serving_worker_*`` families labeled ``lm-0..N-1``). Requests split
round-robin across loops. A request's numbers depend on its batch: the
quantizing substrates scale the activations per tensor, one scale for all
slots of a step (idle slots included), so a greedy output is reproduced
exactly when its request is seated in the same slot beside the same
requests — the first wave of one loop at ``workers=1`` and of the same loop
at ``workers=N`` given the same requests in the same order. A request
seated into a *refilled* slot also attends over the previous occupant's
cache prefix (the shared ``cache_len``), as in ``repro``.

The engine accepts a ``substrate`` override — a
:mod:`repro_torch.nn.substrate` spec, a registry instance, or a per-site
:class:`repro_torch.nn.plan.SubstratePlan` — so int8 / approximate /
mixed-substrate serving runs against the same bundle and parameters.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.obs.trace import trace_span
from repro_torch.serving.batcher import SlotScheduler
from repro_torch.serving.metrics import ServingMetrics


@dataclasses.dataclass
class Request:
    prompt: List[int]
    max_tokens: int = 16
    temperature: float = 0.0
    eos_id: Optional[int] = None
    # filled by the engine
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


def _override_bundle(bundle, substrate):
    """``bundle`` rebuilt on its config with ``substrate`` as the plan."""
    from repro_torch.models import registry as reg
    from repro_torch.nn import plan as plan_mod
    from repro_torch.nn import substrate as psub

    if isinstance(substrate, (plan_mod.SubstratePlan, dict)):
        plan = plan_mod.as_plan(substrate)
    elif isinstance(substrate, str):
        plan = plan_mod.SubstratePlan.uniform(substrate)
    else:
        # the model path resolves by spec string, so a substrate instance
        # must be equivalent to what the registry yields for its spec — a
        # custom subclass would be silently swapped out for the stock backend
        spec = substrate.meta.spec
        stock = psub.get_substrate(spec)
        if type(stock) is not type(substrate) or stock.meta != substrate.meta:
            raise ValueError(
                f"substrate instance {substrate!r} does not match the "
                f"registered backend for {spec!r}; pass a spec string or "
                "register the backend first")
        plan = plan_mod.SubstratePlan.uniform(spec)
    return reg.build_bundle(dataclasses.replace(bundle.cfg, dot_plan=plan))


class ServingEngine:
    def __init__(self, bundle, params, batch_size: int = 4,
                 max_len: int = 256, seed: int = 0, substrate=None,
                 metrics: Optional[ServingMetrics] = None, device=None):
        """bundle / params: a :class:`~repro_torch.models.registry.ModelBundle`
        and its :class:`~repro_torch.models.lm.LM` parameters, on ``device``.
        substrate: optional override for the bundle's substrate assignment —
        a spec string (e.g. ``"int8"``, ``"approx_cuda:proposed@8"``), a
        registry substrate instance, or a
        :class:`~repro_torch.nn.plan.SubstratePlan` (or its dict schema) for
        per-site mixed-substrate serving; the bundle is rebuilt on the
        overridden config (``cfg.dot_plan``) and the same params are served.
        metrics: optional shared :class:`ServingMetrics`; a private one
        otherwise. device: ``None`` (→ ``"cuda"``), ``"cuda[:i]"`` or
        ``"cpu"``."""
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ServingEngine runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run the plain versions")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"device must be cuda or cpu, got {self.device}")
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        p_dev = params.device
        if p_dev.type == "cuda" and p_dev.index is None:
            p_dev = torch.device("cuda", torch.cuda.current_device())
        if p_dev != self.device:
            raise ValueError(f"params lie on {params.device}, the engine "
                             f"runs on {self.device}: move them first")
        if substrate is not None:
            bundle = _override_bundle(bundle, substrate)
        self.bundle = bundle
        self.cfg = bundle.cfg
        self.params = params
        self.batch = batch_size
        self.max_len = max_len
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.metrics = metrics if metrics is not None else ServingMetrics()

    def _init_state(self):
        return self.bundle.init_decode_state(self.batch, self.max_len,
                                             self.device)

    def _step(self, state, tokens: np.ndarray, cache_len: int):
        batch = {"token": torch.as_tensor(tokens.reshape(self.batch, 1),
                                          dtype=torch.int64, device=self.device),
                 "cache_len": cache_len}
        logits, state = self.bundle.decode_step(self.params, state, batch)
        return logits[:, 0, :].to(torch.float32).cpu().numpy(), state

    def _sample(self, logits: np.ndarray, temps: np.ndarray,
                rng: np.random.Generator) -> np.ndarray:
        out = np.empty(self.batch, np.int64)
        for i in range(self.batch):
            if temps[i] <= 0:
                out[i] = logits[i].argmax()
            else:
                z = logits[i] / temps[i]
                z -= z.max()
                p = np.exp(z)
                p /= p.sum()
                out[i] = rng.choice(len(p), p=p)
        return out

    def _stream(self):
        """A context running the calling thread's work on a stream of its
        own, ordered after the work already queued on the current stream
        (the parameters), on the card; nothing on the CPU."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        return torch.cuda.stream(stream)

    def generate(self, requests: List[Request],
                 workers: int = 1) -> List[Request]:
        """Serve a list of requests with continuous slot refill.

        ``workers > 1`` runs that many concurrent decode loops, each with
        its own KV caches, ``batch_size`` slots and CUDA stream (requests
        split round-robin). See the module docstring for which outputs are
        identical at any worker count.
        """
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        workers = min(workers, max(1, len(requests)))
        with trace_span("serve.generate", "serving", requests=len(requests),
                        workers=workers):
            if workers == 1:  # on the caller's stream
                self._generate(requests, self.rng, worker="lm-0")
                return requests
            chunks = [requests[i::workers] for i in range(workers)]
            errors: List[BaseException] = []

            def run(i: int, chunk: List[Request]) -> None:
                try:
                    with self._stream():
                        self._generate(chunk, np.random.default_rng(
                            (self.seed, i)), worker=f"lm-{i}")
                except BaseException as e:  # noqa: BLE001 - re-raised below
                    errors.append(e)

            threads = [threading.Thread(target=run, args=(i, c),
                                        name=f"lm-decode-{i}")
                       for i, c in enumerate(chunks)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if errors:
                raise errors[0]
            return requests

    def _generate(self, requests: List[Request], rng: np.random.Generator,
                  worker: str = "lm-0") -> List[Request]:
        sched = SlotScheduler(self.batch)
        t_start = {}
        for r in requests:
            sched.submit(r)
            t_start[id(r)] = time.perf_counter()
            self.metrics.record_enqueue(len(sched.queue))

        # NOTE: the shared cache_len is the max over slots; per-slot masking
        # is handled by feeding pad tokens for idle slots (logits ignored).
        cache_len = 0
        served: set = set()                           # id(r) with metrics
        state = self._init_state()                    # this loop's KV caches
        cursor = np.zeros(self.batch, np.int64)       # prompt cursor
        while sched.busy and cache_len < self.max_len - 1:
            for i, r in sched.refill():
                if r.done:                           # e.g. re-submitted request
                    sched.release(i)
                    continue
                cursor[i] = 0                        # prompt starts here
            if not sched.occupancy:
                continue                             # nothing seated this step
            tokens = np.zeros(self.batch, np.int64)
            for i, r in sched.occupied():
                if r.done:
                    continue
                if cursor[i] < len(r.prompt):
                    tokens[i] = r.prompt[int(cursor[i])]
                elif r.output:
                    tokens[i] = r.output[-1]
            self.metrics.record_batch(sched.occupancy, "decode", self.batch)
            t_step = time.perf_counter()
            with trace_span("serve.decode_step", "serving",
                            cache_len=cache_len, occupancy=sched.occupancy,
                            worker=worker):
                logits, state = self._step(state, tokens, cache_len)
            self.metrics.record_worker_batch(
                worker, time.perf_counter() - t_step)
            temps = np.array([r.temperature if r else 0.0 for r in sched.slots])
            nxt = self._sample(logits, temps, rng)
            for i, r in sched.occupied():
                if r.done:
                    continue
                cursor[i] += 1
                if cursor[i] >= len(r.prompt):       # past prefill: emit
                    tok = int(nxt[i])
                    r.output.append(tok)
                    if (r.eos_id is not None and tok == r.eos_id) or \
                            len(r.output) >= r.max_tokens:
                        r.done = True
                        sched.release(i)
                        served.add(id(r))
                        self.metrics.record_done(
                            time.perf_counter() - t_start[id(r)],
                            depth=len(sched.queue))
            cache_len += 1
        for r in requests:
            r.done = True
            if id(r) not in served:  # truncated by max_len / never seated
                self.metrics.record_done(
                    time.perf_counter() - t_start[id(r)], ok=False, depth=0)
        return requests
