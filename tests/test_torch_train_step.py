"""The port's optimizer and train step against the JAX package's, on the CPU.

``adamw_update`` over several steps on the same parameters and gradients,
with f32 and with bf16 moments, against ``repro.optim.adamw_update``
(parameters, moments, step, gradient norm and learning rate, and the
cosine schedule on its own); one ``make_train_step`` step of 2 micro-batches
on DBRX's smoke config in f32 over ``LocalComm(4)`` against JAX's on 4 fake
devices, fed the reference pipeline's batch: loss, gradient norm, learning
rate and every updated parameter; the checkpoint refusal over a
``DistComm`` (A10d).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.dbrx_132b import smoke_config as jax_smoke
from repro.data import DataConfig as JDataConfig
from repro.data import DataPipeline as JDataPipeline
from repro.models.transformer import lm_spec as jax_lm_spec
from repro.optim import AdamWConfig as JAdamW
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim import cosine_schedule as j_cosine
from repro.parallel.sharding import init_from_specs
from repro.runtime.steps import make_train_step as j_make_train_step
from repro_torch.comm import LocalComm
from repro_torch.configs.dbrx_132b import smoke_config
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, cosine_schedule
from repro_torch.runtime.steps import make_train_step
from repro_torch.weights import _leaves, params_from_jax

N = 4


def _tree(rng, dtype):
    return {"a": rng.standard_normal((5, 7)).astype(dtype),
            "b": {"c": rng.standard_normal((11,)).astype(dtype),
                  "d": (rng.standard_normal((3, 4, 2)) * 1e-3).astype(dtype)}}


def _np(t):
    return t.detach().float().numpy()


def test_cosine_schedule_matches_jax():
    cfg = dict(lr=3e-4, warmup_steps=5, total_steps=40)
    for step in (0, 1, 4, 5, 6, 20, 39, 40, 55):
        want = float(j_cosine(JAdamW(**cfg), jnp.int32(step)))
        got = cosine_schedule(AdamWConfig(**cfg), torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.item(), want, rtol=1e-6)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(state_dtype):
    """Five steps (warm-up, clipping at the third: its gradients are scaled
    past clip_norm) on f32 parameters: within 1e-6 with f32 moments; with
    bf16 moments every moment within one bf16 step of JAX's and the
    parameters within 1e-6."""
    rng = np.random.default_rng(0)
    params = _tree(rng, np.float32)
    base = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1)
    jcfg = JAdamW(state_dtype=getattr(jnp, state_dtype), **base)
    tcfg = AdamWConfig(state_dtype=getattr(torch, state_dtype), **base)
    jp = jax.tree.map(jnp.asarray, params)
    jst = j_adamw_init(jp, jcfg)
    tp = {"a": torch.from_numpy(params["a"].copy()),
          "b": {k: torch.from_numpy(v.copy()) for k, v in params["b"].items()}}
    tst = adamw_init(tp, tcfg)
    for step in range(5):
        grads = _tree(rng, np.float32)
        if step == 2:
            grads = jax.tree.map(lambda g: g * 10.0, grads)
        jp, jst, jm = j_adamw_update(jp, jax.tree.map(jnp.asarray, grads), jst, jcfg)
        tg = {"a": torch.from_numpy(grads["a"]),
              "b": {k: torch.from_numpy(v) for k, v in grads["b"].items()}}
        tp, tst, tm = adamw_update(tp, tg, tst, tcfg)
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(tm["lr"].item(), float(jm["lr"]), rtol=1e-6)
        assert int(tst["step"]) == int(jst["step"]) == step + 1
        for (path, t), w in zip(_leaves(tp), jax.tree.leaves(jp)):
            np.testing.assert_allclose(_np(t), np.asarray(w), rtol=1e-6, atol=1e-6)
        for key in ("m", "v"):
            for (path, t), w in zip(_leaves(tst[key]), jax.tree.leaves(jst[key])):
                assert t.dtype == getattr(torch, state_dtype)
                w = np.asarray(w.astype(jnp.float32))
                if state_dtype == "float32":
                    np.testing.assert_allclose(_np(t), w, rtol=1e-6, atol=1e-12)
                else:
                    np.testing.assert_allclose(_np(t), w, rtol=2 ** -7, atol=1e-12)


def test_train_step_two_microbatches_matches_jax():
    """One step of make_train_step with 2 micro-batches of 4 rows of 32
    tokens, HT flat at capacity 1.25 over 4 ranks, f32: loss within 1e-5,
    gradient norm within 1e-4, the learning rate exactly, every updated
    parameter within 1e-5 of JAX's but for at most one element in a
    thousand, and those within a tenth of the learning rate (AdamW's first
    step moves each element by about lr)."""
    ep = dict(ep_mode="ht", capacity_factor=1.25, expert_capacity_factor=1.25)
    jcfg, tcfg = jax_smoke(), smoke_config()
    jcfg = dataclasses.replace(jcfg, dtype=jnp.float32, microbatch=2,
                               moe=dataclasses.replace(jcfg.moe, **ep))
    tcfg = dataclasses.replace(tcfg, dtype=torch.float32, microbatch=2,
                               moe=dataclasses.replace(tcfg.moe, **ep))
    tree = jax.device_get(init_from_specs(jax.random.PRNGKey(1), jax_lm_spec(jcfg)))
    params = params_from_jax(tree, tcfg, device="cpu")
    batch = jax.device_get(JDataPipeline(JDataConfig(vocab=jcfg.vocab, seq_len=32,
                                                     global_batch=8, microbatch=2,
                                                     seed=3)).batch_at(0))
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    mesh = jax.make_mesh((N,), ("data",), axis_types=(jax.sharding.AxisType.Auto,),
                         devices=jax.devices()[:N])
    jstep = jax.jit(j_make_train_step(jcfg, mesh, JAdamW(**opt)))
    jp, _, jm = jstep(tree, j_adamw_init(tree, JAdamW(**opt)),
                      jax.tree.map(jnp.asarray, batch))
    step = make_train_step(tcfg, LocalComm(N), AdamWConfig(**opt))
    tp, tst, tm = step(params, adamw_init(params, AdamWConfig(**opt)),
                       {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-4)
    assert tm["lr"].item() == float(jm["lr"])
    assert int(tst["step"]) == 1
    want = {tuple(str(getattr(k, "key", k)) for k in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    lr = opt["lr"]
    for path, t in _leaves(tp):
        got, w = _np(t), np.asarray(want[path])
        # Adam's first step moves an element by lr * g / (|g| + eps): where g
        # is near the f32 noise of two summation orders the move itself is
        # noisy, so a few elements may differ by a fraction of lr
        np.testing.assert_allclose(got, w, rtol=1e-5, atol=0.1 * lr, err_msg="/".join(path))
        assert (np.abs(got - w) > 1e-5 + 1e-5 * np.abs(w)).mean() <= 1e-3, "/".join(path)


def test_train_step_refuses_dist_comm():
    """What training over a DistComm still refuses: a checkpoint directory
    (each process holds only its own experts; ROADMAP A10d). The train
    step itself takes a DistComm (tests/test_torch_dist_train.py)."""
    from repro_torch.comm import DistComm
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    comm = DistComm.__new__(DistComm)
    make_train_step(smoke_config(), comm)
    with pytest.raises(NotImplementedError, match="ckpt_dir over a DistComm.*A10d"):
        Trainer(smoke_config(), TrainerConfig(ckpt_dir="unused"), comm=comm, device="cpu")
