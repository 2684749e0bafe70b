"""Training loop (port of ``src/repro/runtime/trainer.py``): the
micro-batched train step, checkpointing in the reference's format, the
preemption guard and the straggler watchdog, for any ported architecture
over a ``LocalComm`` (one process hosting every EP rank), a ``DistComm``
(one EP rank per process) or none.

Over a ``DistComm`` each process holds its shard of the parameters
(``init_params(..., comm=)``), draws the same global batch (the pipeline
is a function of (seed, step)) and steps its rows of each micro-batch
(``comm.batch_rows``); the loss and the gradient norm it logs are the
global ones, equal on every process, and only the process of rank 0
prints them. A checkpoint over a ``DistComm`` is refused (ROADMAP A10d).

The state is (params, AdamW state), the pipeline's (step, seed) beside it
in each checkpoint, a tree ``(params, opt, {step, seed})`` that the
reference's ``restore_checkpoint`` reads with its specs and the other way
round. Entry points run on the card unless ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.comm import DistComm
from repro_torch.checkpoint.store import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.data import DataConfig, DataPipeline
from repro_torch.device import resolve_device, synchronize
from repro_torch.models import get_model
from repro_torch.models.config import ArchConfig
from repro_torch.optim import AdamWConfig, adamw_init, adamw_init_specs
from repro_torch.runtime.fault import PreemptionGuard, StepTimer, StragglerWatchdog
from repro_torch.runtime.steps import make_train_step
from repro_torch.weights import init_params


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    global_batch: int = 8
    seq_len: int = 128
    ckpt_dir: str | None = None
    ckpt_every: int = 50
    log_every: int = 10
    seed: int = 0


class Trainer:
    def __init__(self, cfg: ArchConfig, tcfg: TrainerConfig, comm=None,
                 opt_cfg: AdamWConfig | None = None, device=None):
        if cfg.moe and cfg.moe.params_physical:
            # adopt-once physical weights are a serving layout: replicas of
            # one expert would get separate gradients and diverge
            raise ValueError(
                "MoESpec.params_physical=True is a serving-only layout; "
                "train with params_physical=False (logical expert weights)")
        if isinstance(comm, DistComm) and tcfg.ckpt_dir is not None:
            raise NotImplementedError(
                "ckpt_dir over a DistComm: each process holds only its own experts, "
                "and a sharded checkpoint format is not the reference's (ROADMAP A10d)")
        self.cfg, self.tcfg, self.comm = cfg, tcfg, comm
        self._dist = isinstance(comm, DistComm)
        self.device = resolve_device(device)
        self.opt_cfg = opt_cfg or AdamWConfig(
            total_steps=tcfg.steps, warmup_steps=max(tcfg.steps // 20, 1))
        self.model = get_model(cfg)
        self.data = DataPipeline(DataConfig(
            vocab=cfg.vocab, seq_len=tcfg.seq_len, global_batch=tcfg.global_batch,
            microbatch=max(cfg.microbatch, 1), seed=tcfg.seed), self.device)
        self.step_fn = make_train_step(cfg, comm, self.opt_cfg)
        self.guard = PreemptionGuard()
        self.watchdog = StragglerWatchdog()
        self.metrics_log: list[dict] = []

    # ---- state management ----
    def init_state(self):
        params = init_params(self.cfg, self.tcfg.seed, self.device,
                             comm=self.comm if self._dist else None)
        return params, adamw_init(params, self.opt_cfg)

    def next_batch(self) -> dict:
        """The pipeline's next global batch, or over a ``DistComm`` this
        process's rows of each of its micro-batches."""
        batch = next(self.data)
        if not self._dist:
            return batch
        rows = self.comm.batch_rows(batch["tokens"].shape[1])
        return {k: v[:, rows] for k, v in batch.items()}

    def maybe_restore(self):
        if not self.tcfg.ckpt_dir:
            return None
        step = latest_step(self.tcfg.ckpt_dir)
        if step is None:
            return None
        pspec = self.model.params_spec(self.cfg)
        ospec = adamw_init_specs(pspec, self.opt_cfg)
        (params, opt, dstate), _ = restore_checkpoint(
            self.tcfg.ckpt_dir, step,
            (pspec, ospec, dict(step=np.zeros((), np.int64), seed=np.zeros((), np.int64))),
            device=self.device)
        self.data.restore({k: int(v) for k, v in dstate.items()})
        return params, opt

    def save(self, params, opt):
        if not self.tcfg.ckpt_dir:
            return
        ds = self.data.state()
        save_checkpoint(self.tcfg.ckpt_dir, self.data.step,
                        (params, opt, {k: np.int64(v) for k, v in ds.items()}))

    # ---- main loop ----
    def run(self):
        restored = self.maybe_restore()
        if restored is not None:
            params, opt = restored
            print(f"[trainer] resumed at data step {self.data.step}")
        else:
            params, opt = self.init_state()
        preempted = False
        while self.data.step < self.tcfg.steps:
            batch = self.next_batch()
            t = StepTimer()
            with t:
                params, opt, m = self.step_fn(params, opt, batch)
                synchronize(self.device)
            if self.watchdog.observe(t.times[-1]):
                print(f"[watchdog] straggler step {self.data.step}: "
                      f"{t.times[-1]:.2f}s vs ema {self.watchdog.ema:.2f}s")
            if self.data.step % self.tcfg.log_every == 0:
                rec = dict(step=self.data.step, loss=float(m["loss"]),
                           gnorm=float(m["grad_norm"]), t=t.times[-1],
                           stragglers_flagged=self.watchdog.flagged,
                           watchdog_rebased=self.watchdog.rebased)
                self.metrics_log.append(rec)
                if not self._dist or self.comm.rank == 0:
                    print(f"[train] step={rec['step']} loss={rec['loss']:.4f} "
                          f"gnorm={rec['gnorm']:.3f} {rec['t'] * 1e3:.0f}ms"
                          + (f" stragglers={rec['stragglers_flagged']}"
                             if rec['stragglers_flagged'] else ""))
            if self.tcfg.ckpt_dir and self.data.step % self.tcfg.ckpt_every == 0:
                self.save(params, opt)
            stop = self.guard.should_stop
            if self._dist:
                # every process leaves at the same step, or the others would
                # wait in the next step's collectives
                stop = bool(self.comm.control_max([stop])[0])
            if stop:
                print("[trainer] preemption signal — checkpoint + exit")
                self.save(params, opt)
                preempted = True
                break
        if not preempted and self.tcfg.ckpt_dir:
            self.save(params, opt)
        return params, opt
