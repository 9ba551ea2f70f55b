"""Fault-tolerant training loop (``repro.training.trainer``), at one rank
or on a mesh.

* Checkpoint/restart: periodic async atomic snapshots; when a step fails
  the loop restores the last committed checkpoint and replays from there.
  The synthetic data is a pure function of (seed, step), so a replayed run
  is bit-identical to an uninterrupted one.
* Straggler monitor: a per-step wall-time EWMA; a step slower than
  ``straggler_factor`` times the EWMA is logged and counted.
* Non-finite guard: the train step skips an update whose loss or gradient
  norm is NaN/inf; after ``nan_limit`` consecutive skips the loop escalates
  to checkpoint replay.

On a mesh (a ``parallel.mesh.Mesh`` over an initialised process group)
every rank runs the loop: it holds its shard of the state and feeds its
rows of each global batch; checkpoints are saved whole by rank 0 in the
one-rank layout and cut again at restore (``checkpoint.manager``), so the
fault-hook replay restores onto the same shards.

Elastic re-meshing: ``Trainer.rescale`` moves a live state onto another
mesh (or none) and rebuilds the step for it, its context, batch specs
and plan resolution with it; training goes on at the same step counter,
and later checkpoints restore onto the new mesh's shards. The state is
gathered whole on the old mesh first (``reshard_state``), so a mesh over
fewer ranks (after losing some) loses no data: the ranks outside it get
None and leave the loop. The trainer runs on the card unless it is given
``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import inspect
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager, TensorSpec
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.device import DeviceLike, dtype_of, resolve_device
from repro_torch.launch import specs as SP
from repro_torch.launch.train_step import build_train_step
from repro_torch.models import lm
from repro_torch.models.common import tree_map
from repro_torch.optim.adamw import AdamW
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.mesh import AxisCtx

Tree = Any


class StragglerMonitor:
    """EWMA step-time tracker; flags outlier steps."""

    def __init__(self, factor: float = 2.5, alpha: float = 0.2,
                 on_straggler: Optional[Callable[[int, float, float],
                                                 None]] = None):
        self.factor = factor
        self.alpha = alpha
        self.ewma: Optional[float] = None
        self.flagged: List[int] = []
        self.on_straggler = on_straggler

    def observe(self, step: int, dt: float) -> bool:
        is_straggler = (self.ewma is not None
                        and dt > self.factor * self.ewma)
        if is_straggler:
            self.flagged.append(step)
            if self.on_straggler:
                self.on_straggler(step, dt, self.ewma)
        else:  # don't poison the EWMA with outliers
            self.ewma = dt if self.ewma is None else (
                self.alpha * dt + (1 - self.alpha) * self.ewma)
        return is_straggler


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: str = "/tmp/repro_ckpt"
    ckpt_every: int = 50
    keep: int = 3
    log_every: int = 10
    straggler_factor: float = 2.5
    seed: int = 0
    max_restarts: int = 3
    # after this many CONSECUTIVE skipped (non-finite) steps the loop
    # escalates to checkpoint replay: the state itself is poisoned
    nan_limit: int = 3
    # tuned plans (core/adaptive.py): every moe_ffn under the train step
    # resolves its schedule (transport, ring_group, n_col, gemm backend)
    # from this cache's train-phase entries, keyed by plan_hw
    plan_cache: str = ""
    plan_hw: str = ""


def abstract_state(cfg) -> Dict:
    """The training state's structure, shapes and dtypes, for restore."""
    dt = dtype_of(cfg.param_dtype)
    schema = lm.model_schema(cfg)
    params = tree_map(lambda d: TensorSpec(d.shape, d.leaf_dtype(dt)),
                      schema)

    def f32(s):
        return TensorSpec(s.shape, torch.float32)

    return {"params": params,
            "opt": {"m": tree_map(f32, params), "v": tree_map(f32, params),
                    "count": 0},
            "step": 0}


def reshard_state(state: Dict, cfg, old_ctx: Optional[AxisCtx],
                  new_ctx: Optional[AxisCtx], fsdp: bool = True
                  ) -> Optional[Dict]:
    """Elastic path: a train state cut for ``old_ctx``'s mesh, cut for
    ``new_ctx``'s (``repro/training/trainer.py:72``). A context that is
    None or inactive stands for the whole state on one device. Gathering
    is collective over the old mesh (``sharding.gather_state``), cutting
    local (``shard_state``); a rank outside the new mesh gets None. The
    leaves come back without autograd history (the step marks them)."""
    with torch.no_grad():
        whole = (SH.gather_state(state, cfg, old_ctx, fsdp)
                 if old_ctx is not None and old_ctx.active else state)
        if new_ctx is None or not new_ctx.active:
            return whole
        if not new_ctx.mesh.member:
            return None
        return SH.shard_state(whole, cfg, new_ctx, fsdp)


class Trainer:
    def __init__(self, cfg, shape, mesh=None,
                 tcfg: TrainerConfig = TrainerConfig(),
                 optim: Optional[AdamW] = None,
                 fault_hook: Optional[Callable] = None,
                 device: DeviceLike = None, fsdp: bool = True):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.shape = shape
        self.tcfg = tcfg
        self.optim = optim or AdamW()
        self.fsdp = fsdp
        self.fault_hook = fault_hook          # tests inject failures here
        self._build(mesh)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep)
        self.monitor = StragglerMonitor(tcfg.straggler_factor)
        self.metrics_log: List[Dict[str, float]] = []
        self.nan_skips = 0                    # total skipped updates
        self._consec_nans = 0
        self.data = SyntheticLM(cfg, self.built["batch_structs"],
                                seed=tcfg.seed)

    def _build(self, mesh):
        """The step for ``mesh`` (None: one rank) and what goes with it."""
        self.mesh = mesh
        self.built = build_train_step(self.cfg, self.shape, mesh, self.optim,
                                      fsdp=self.fsdp,
                                      plan_cache=self.tcfg.plan_cache,
                                      plan_hw=self.tcfg.plan_hw)
        self.ctx = self.built["ctx"]
        # on a mesh every rank takes part in a save; rank 0 writes
        self.writer = mesh is None or dist.get_rank() == 0

    # ------------------------------------------------------------------ state
    def init_state(self, seed: Optional[int] = None) -> Dict:
        """Seeded weights on the trainer's device, zero AdamW moments. On a
        mesh: this rank's shard of the weights the one-rank trainer draws
        from the same seed."""
        params = lm.init_params(self.cfg, self.tcfg.seed if seed is None
                                else seed, self.device)
        if self.mesh is not None:
            params = SH.to_mesh(params, self.cfg, self.ctx, self.fsdp)
        return {"params": params, "opt": self.optim.init(params), "step": 0}

    def restore_or_init(self) -> Tuple[Dict, int]:
        if self.mesh is not None:             # every rank sees one latest
            self.ckpt.sync(self.mesh.group(self.mesh.axis_names).pg)
        if self.ckpt.latest_step() is not None:
            if self.mesh is not None:
                return self.ckpt.restore_sharded(
                    abstract_state(self.cfg),
                    lambda s: SH.shard_state(s, self.cfg, self.ctx,
                                             self.fsdp), device=self.device)
            return self.ckpt.restore(abstract_state(self.cfg),
                                     device=self.device)
        return self.init_state(), 0

    def save(self, step: int, state: Dict, wait: bool = False):
        """A checkpoint of ``state`` (collective on a mesh)."""
        if self.mesh is None:
            self.ckpt.save(step, state, wait=wait)
            return
        self.ckpt.save_sharded(
            step, state, lambda s: SH.gather_state(s, self.cfg, self.ctx,
                                                   self.fsdp),
            self.writer, wait=wait)

    # ------------------------------------------------------------------- run
    def _device_batch(self, np_batch: Dict[str, np.ndarray]):
        """The global batch on the device; on a mesh this rank's rows."""
        def conv(t):
            if not t.is_floating_point():
                t = t.long()
            return t.to(self.device)
        batch = {k: torch.from_numpy(v) for k, v in np_batch.items()}
        if self.mesh is not None:
            batch = SP.local_batch(batch, self.built["batch_pspecs"],
                                   self.mesh)
        return {k: conv(v) for k, v in batch.items()}

    def run(self, num_steps: int) -> Dict[str, Any]:
        """Train with checkpoint/restart. Returns a summary dict."""
        state, step = self.restore_or_init()
        restarts = 0
        while step < num_steps:
            try:
                state, step = self._run_span(state, step, num_steps)
            except Exception as e:  # node failure / injected fault
                restarts += 1
                if restarts > self.tcfg.max_restarts:
                    raise
                if self.mesh is None:
                    self.ckpt.wait()
                print(f"[trainer] failure after step {step} "
                      f"({type(e).__name__}: {e}); restoring from "
                      f"step {self.ckpt.latest_step() or 0} "
                      f"(restart {restarts}/{self.tcfg.max_restarts})")
                state = None                  # free it before the restore
                state, step = self.restore_or_init()
                self._consec_nans = 0
        self.save(step, state, wait=True)
        return {"final_step": step, "restarts": restarts,
                "stragglers": list(self.monitor.flagged),
                "nan_skips": self.nan_skips,
                "metrics": self.metrics_log}

    def _apply_fault_hook(self, step, state):
        """Fault hooks take ``(step)`` (raise to simulate a node failure)
        or ``(step, state) -> state`` (may also corrupt the state)."""
        try:
            nparams = len(inspect.signature(self.fault_hook).parameters)
        except (TypeError, ValueError):
            nparams = 1
        if nparams >= 2:
            out = self.fault_hook(step, state)
            return state if out is None else out
        self.fault_hook(step)
        return state

    def _run_span(self, state, step, num_steps):
        step_fn = self.built["fn"]
        while step < num_steps:
            if self.fault_hook is not None:
                state = self._apply_fault_hook(step, state)
            batch = self._device_batch(self.data.batch_at(step))
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])     # waits for the step
            dt = time.perf_counter() - t0
            step += 1
            self.monitor.observe(step, dt)
            skipped = bool(metrics["skipped"]) or not np.isfinite(loss)
            if skipped:
                self.nan_skips += 1
                self._consec_nans += 1
                print(f"[trainer] step {step}: non-finite loss/grads - "
                      f"update skipped ({self._consec_nans} consecutive, "
                      f"{self.nan_skips} total)")
                if self._consec_nans > self.tcfg.nan_limit:
                    raise FloatingPointError(
                        f"{self._consec_nans} consecutive non-finite steps "
                        f"at step {step} (nan_limit {self.tcfg.nan_limit})")
            else:
                self._consec_nans = 0
            rec = {"step": step, "loss": loss, "time_s": dt,
                   "skipped": int(skipped),
                   "grad_norm": float(metrics["grad_norm"])}
            self.metrics_log.append(rec)
            if step % self.tcfg.log_every == 0:
                print(f"[trainer] step {step} loss {loss:.4f} "
                      f"({dt * 1e3:.0f} ms)")
            if step % self.tcfg.ckpt_every == 0 and self._consec_nans == 0:
                # never checkpoint mid-NaN-streak
                self.save(step, state)
        return state, step


    # ----------------------------------------------------------- elastic path
    def rescale(self, state: Dict, new_mesh) -> Optional[Dict]:
        """Re-mesh a live state (e.g. after losing ranks) and rebuild the
        step for ``new_mesh`` (None: one rank, the state whole on the
        trainer's device). Collective over the default group: every rank
        of the old mesh calls it. Returns the state cut for the new mesh,
        or None on a rank outside it, which leaves the loop. The new
        layout may change (ep, etp) and each rank's tokens: the MoE
        layers' plan keys resolve again from the same cache."""
        # gathered on the old mesh before the new one's groups are built
        whole = reshard_state(state, self.cfg, self.ctx, None, self.fsdp)
        self._build(new_mesh)
        return reshard_state(whole, self.cfg, None, self.ctx, self.fsdp)


# ---------------------------------------------------------------------------
# self-test entry (runs on every rank of an initialised process group)
# ---------------------------------------------------------------------------


def smoke_train(arch: str, mesh, steps: int = 4, device: DeviceLike = None,
                no_drop: bool = False) -> List[float]:
    """The losses of ``steps`` Trainer steps of ``arch`` on ``mesh`` (None:
    one rank) at the self-test's shape: 64 tokens, max(4, 2 x dp) rows.
    ``no_drop`` sets the MoE capacity factor to the expert count, so a
    mesh routes every token as one rank does. On a mesh rank 0 picks the
    checkpoint directory; without one each rank has its own."""
    import tempfile

    from repro_torch.configs import ShapeConfig, get_config
    cfg = get_config(arch)
    if no_drop and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    dp = mesh.shape.get("data", 1) if mesh is not None else 1
    shape = ShapeConfig("smoke", seq_len=64, global_batch=max(4, 2 * dp),
                        kind="train")
    ckpt = [tempfile.mkdtemp(prefix="repro_torch_st_")
            if mesh is None or dist.get_rank() == 0 else None]
    if mesh is not None:
        dist.broadcast_object_list(ckpt, src=0)
    tcfg = TrainerConfig(ckpt_dir=ckpt[0], ckpt_every=10_000,
                         log_every=10_000)
    out = Trainer(cfg, shape, mesh, tcfg, device=device).run(steps)
    return [m["loss"] for m in out["metrics"]]


def smoke_mesh_train(arch: str, n_dev: int, steps: int = 4,
                     device: DeviceLike = None) -> Tuple[float, float]:
    """(first loss, last loss) of ``steps`` steps on a (n_dev / mp, mp)
    ("data", "model") mesh, mp = min(4, n_dev), of the initialised
    process group's n_dev ranks (``repro/training/trainer.py:267``)."""
    from repro_torch.parallel.mesh import make_mesh
    mp = min(4, n_dev)
    mesh = make_mesh((n_dev // mp, mp), ("data", "model"))
    losses = smoke_train(arch, mesh, steps, device)
    return losses[0], losses[-1]
