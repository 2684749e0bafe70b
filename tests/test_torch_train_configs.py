"""Training DeepSeek-V3 and the dense ``lm`` configs in the port against the
JAX package's AD, f32 on the CPU.

* ``models/mla.py MlaChunked``, the chunked MLA attention with a
  recomputing backward: its forward bitwise the plain loop
  (``_mla_chunked``), its gradients within 1e-5 (of each one's largest
  value) of autograd of the loop and of ``jax.vjp`` of the reference's
  ``_mla_chunked``, at an even and a ragged S over ``kv_chunk`` 8.
* ``jax.value_and_grad`` of the reference's ``lm_forward`` against the
  port's: DeepSeek-V3's smoke config (MLA, sigmoid group-limited routing
  with nonzero selection biases, a shared expert, ``first_k_dense``, the
  0.3-weighted MTP term) over ``LocalComm(4)`` against 4 fake devices, and
  ChatGLM3-6B, InternLM2-20B and MiniCPM3-4B (MLA at heads padded 4 -> 16,
  tied embeddings) with no mesh: the loss within 1e-5, every gradient
  within 1e-4 of its largest value. Both packages' MLA takes its chunked
  branch (``CHUNKED_ATTN_THRESHOLD`` 1; the reference's short branch masks
  with the transposed causal mask, ``tests/test_torch_mla.py``), so the
  port's goes through ``MlaChunked``.
* Two micro-batched ``make_train_step`` steps of DeepSeek-V3 over
  ``LocalComm(4)`` against two of JAX's jitted ``make_train_step``.
* Every floating DeepSeek-V3 parameter gets a nonzero gradient but the
  selection bias, which no loss term reaches (JAX's gradient for it is
  zero, the port's None; AdamW treats both as zero).
* ``Trainer`` on each config: the losses finite and falling.

The selection bias's weight decay makes its step differ from zero: the
steps hold it nonzero, as ``tests/test_torch_deepseek.py jax_tree`` draws
it. The DeepSeek-V3 smoke case over a gloo ``DistComm``:
``tests/test_torch_dist_train.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import repro.models.attention as JATT
from repro.configs import get_smoke as jax_get_smoke
from repro.models import get_model as jax_get_model
from repro.models import mla as JMLA
from repro.optim import AdamWConfig as JAdamW
from repro.optim import adamw_init as j_adamw_init
from repro.runtime.steps import make_train_step as j_make_train_step
from repro_torch.comm import LocalComm
from repro_torch.configs import get_smoke
from repro_torch.models import get_model
from repro_torch.models import mla as MLA
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime.steps import make_train_step
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.weights import _leaves, params_from_jax
from test_torch_deepseek import jax_tree
from test_torch_dist_train import OPT, _params_close, _rel_close

N = 4
DS = "deepseek-v3-671b"
ARCHS = [DS, "chatglm3-6b", "internlm2-20b", "minicpm3-4b"]
MLA_ARCHS = (DS, "minicpm3-4b")
CHUNK, S = 8, 20              # a ragged last KV chunk


def cfgs(arch, **kw):
    """The f32 smoke configs of both packages, KV chunks of CHUNK."""
    out = []
    for cfg, dt in ((jax_get_smoke(arch), jnp.float32), (get_smoke(arch), torch.float32)):
        cfg = dataclasses.replace(cfg, dtype=dt, attn=dataclasses.replace(cfg.attn,
                                                                          kv_chunk=CHUNK))
        out.append(dataclasses.replace(cfg, **kw))
    return out


def mesh4():
    return jax.make_mesh((N,), ("data",), axis_types=(jax.sharding.AxisType.Auto,),
                         devices=jax.devices()[:N])


def named(tree) -> dict:
    return {tuple(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture
def chunked(monkeypatch):
    """Both packages' MLA on its chunked branch at every S."""
    monkeypatch.setattr(JATT, "CHUNKED_ATTN_THRESHOLD", 1)
    monkeypatch.setattr(MLA, "CHUNKED_ATTN_THRESHOLD", 1)


# ---------------------------------------------------------------------------
# MlaChunked
# ---------------------------------------------------------------------------

def mla_inputs(seq: int) -> tuple[dict, np.ndarray]:
    """Smoke-width MLA inputs (4 heads, nope 16, rope 8, r_kv 16, dv 16)
    and an output cotangent, from a seed."""
    rng = np.random.default_rng(seq)
    shapes = dict(q_nope=(1, seq, 4, 16), q_rope=(1, seq, 4, 8), ckv=(1, seq, 16),
                  k_rope=(1, seq, 8), wk_b=(16, 4, 16), wv_b=(16, 4, 16))
    a = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    return a, rng.standard_normal((1, seq, 4, 16)).astype(np.float32)


SCALE = 24 ** -0.5


@pytest.mark.parametrize("seq", [16, S])
def test_mla_chunked_forward_is_the_plain_loop(seq):
    """MlaChunked's forward, with and without grad, is bitwise the plain
    loop's output."""
    a, _ = mla_inputs(seq)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    want = MLA._mla_chunked(t, t["q_nope"], t["q_rope"], t["ckv"], t["k_rope"], SCALE,
                            torch.float32, chunk=CHUNK)
    with torch.no_grad():
        got = MLA.MlaChunked.apply(*t.values(), SCALE, torch.float32, CHUNK)
    assert torch.equal(got, want)
    tg = [v.clone().requires_grad_() for v in t.values()]
    got = MLA.MlaChunked.apply(*tg, SCALE, torch.float32, CHUNK)
    assert got.grad_fn is not None and torch.equal(got.detach(), want)


@pytest.mark.parametrize("seq", [16, S])
def test_mla_chunked_gradients(seq):
    """Every input's gradient through MlaChunked within 1e-5 of its largest
    value of autograd through the plain loop and of jax.vjp of the
    reference's _mla_chunked; the backward ran once."""
    a, go = mla_inputs(seq)
    names = list(a)

    def jf(q_nope, q_rope, ckv, k_rope, wk_b, wv_b):
        return JMLA._mla_chunked({"wk_b": wk_b, "wv_b": wv_b}, q_nope, q_rope, ckv, k_rope,
                                 SCALE, jnp.float32, chunk=CHUNK)
    _, vjp = jax.vjp(jf, *(jnp.asarray(a[n]) for n in names))
    want = [np.asarray(g) for g in vjp(jnp.asarray(go))]
    fn = [torch.from_numpy(a[n]).requires_grad_() for n in names]
    calls = MLA.mla_chunked_bwd_calls
    MLA.MlaChunked.apply(*fn, SCALE, torch.float32, CHUNK).backward(torch.from_numpy(go))
    assert MLA.mla_chunked_bwd_calls == calls + 1
    loop = [torch.from_numpy(a[n]).requires_grad_() for n in names]
    MLA._mla_chunked({"wk_b": loop[4], "wv_b": loop[5]}, *loop[:4], SCALE, torch.float32,
                     chunk=CHUNK).backward(torch.from_numpy(go))
    for n, f, lp, w in zip(names, fn, loop, want):
        _rel_close(f.grad.numpy(), lp.grad.numpy(), 1e-5, f"{n} against the loop")
        _rel_close(f.grad.numpy(), w, 1e-5, f"{n} against jax.vjp")


# ---------------------------------------------------------------------------
# lm_forward's value and gradient, every lm config
# ---------------------------------------------------------------------------

def _tree(jcfg, arch):
    return jax_tree(jcfg, seed=ARCHS.index(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_value_and_grad_matches_jax(arch, chunked):
    """jax.value_and_grad of the reference's lm_forward against the port's:
    DeepSeek-V3 over LocalComm(4) against 4 fake devices (one row a rank),
    the dense configs with no mesh; the loss within 1e-5, every gradient
    within 1e-4 of its largest value (DeepSeek-V3's selection bias: JAX's
    zero, the port's None); the MLA configs through MlaChunked."""
    jcfg, tcfg = cfgs(arch)
    tree = _tree(jcfg, arch)
    params = params_from_jax(tree, tcfg, device="cpu")
    rng = np.random.default_rng(30 + ARCHS.index(arch))
    batch = dict(tokens=rng.integers(0, jcfg.vocab, (N, S)).astype(np.int32))
    batch["loss_mask"] = (rng.random((N, S)) > 0.2).astype(np.float32)
    ds = arch == DS
    m, comm = (mesh4(), LocalComm(N)) if ds else (None, None)
    jfwd = jax_get_model(jcfg).forward
    (wl, _), wg = jax.jit(jax.value_and_grad(
        lambda p, b: jfwd(p, b, jcfg, m), has_aux=True))(
            tree, {k: jnp.asarray(v) for k, v in batch.items()})
    ps = {path: t.requires_grad_() for path, t in _leaves(params)}
    calls = MLA.mla_chunked_bwd_calls
    loss, _ = get_model(tcfg).forward(params, {k: torch.from_numpy(v) for k, v in batch.items()},
                                      tcfg, comm)
    loss.backward()
    if arch in MLA_ARCHS:       # one call a row and a layer (DeepSeek-V3's MTP layer too)
        assert MLA.mla_chunked_bwd_calls - calls == N * (tcfg.num_layers + int(tcfg.mtp))
    np.testing.assert_allclose(loss.item(), float(wl), rtol=1e-5, atol=1e-5)
    want = named(wg)
    assert set(want) == set(ps)
    for path, t in ps.items():
        if path[-1] == "sel_bias":
            assert t.grad is None and not want[path].any(), path
            continue
        _rel_close(t.grad.numpy(), want[path], 1e-4, "/".join(path))


def test_every_deepseek_parameter_gets_a_gradient(chunked):
    """DeepSeek-V3's smoke config over LocalComm(4): every floating
    parameter gets a nonzero gradient, the MTP layer's, the shared
    expert's and the dense prefix's too, but the selection biases: they
    pick experts and weigh none (sigmoid routing takes its weights from
    the unbiased scores), so no loss term reaches them."""
    _, tcfg = cfgs(DS)
    from repro_torch.weights import init_params
    params = init_params(tcfg, 0, "cpu")
    toks = np.random.default_rng(7).integers(0, tcfg.vocab, (N, S)).astype(np.int32)
    ps = {path: t.requires_grad_() for path, t in _leaves(params) if t.is_floating_point()}
    loss, _ = get_model(tcfg).forward(params, {"tokens": torch.from_numpy(toks)}, tcfg,
                                      LocalComm(N))
    loss.backward()
    biases = [p for p in ps if p[-1] == "sel_bias"]
    assert len(biases) == 2                     # the MoE stack's and the MTP layer's
    for path, t in ps.items():
        if path[-1] == "sel_bias":
            assert t.grad is None, path
        else:
            assert t.grad is not None and t.grad.abs().sum() > 0, "/".join(path)


# ---------------------------------------------------------------------------
# train steps and the Trainer
# ---------------------------------------------------------------------------

def test_deepseek_train_steps_match_jax(chunked):
    """Two steps of make_train_step (2 micro-batches of 4 rows of S tokens,
    AdamW clipping at the global norm) over LocalComm(4) against two of
    JAX's jitted make_train_step on 4 fake devices: the loss within 1e-5,
    the gradient norm within 1e-4, the learning rate exactly, every
    parameter within test_torch_train_step's tolerance (the nonzero
    selection biases decay alike)."""
    jcfg, tcfg = cfgs(DS, microbatch=2)
    tree = _tree(jcfg, DS)
    params = params_from_jax(tree, tcfg, device="cpu")
    rng = np.random.default_rng(40)
    batches = [{k: rng.integers(0, jcfg.vocab, (2, N, S)).astype(np.int32)
                for k in ("tokens", "targets")} for _ in range(2)]
    # inputs and outputs placed alike, so the second step reuses the first
    # one's executable
    m = mesh4()
    rep = NamedSharding(m, P())
    jstep = jax.jit(j_make_train_step(jcfg, m, JAdamW(**OPT)), in_shardings=rep,
                    out_shardings=rep)
    jp, jst = jax.device_put((tree, j_adamw_init(tree, JAdamW(**OPT))), rep)
    step = make_train_step(tcfg, LocalComm(N), AdamWConfig(**OPT))
    tp, tst = params, adamw_init(params, AdamWConfig(**OPT))
    for i, b in enumerate(batches):
        jp, jst, jm = jstep(jp, jst, jax.device_put(b, rep))
        tp, tst, tm = step(tp, tst, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-4)
        assert tm["lr"].item() == float(jm["lr"])
        want = named(jax.device_get(jp))
        _params_close({"/".join(p): t.detach().numpy() for p, t in _leaves(tp)},
                      {"/".join(p): v for p, v in want.items()}, f"step {i + 1}")
    # the biases moved: weight decay alone, as JAX's did
    bias = tp["moe_stack"]["moe"]["sel_bias"].detach().numpy()
    assert (bias != tree["moe_stack"]["moe"]["sel_bias"]).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_loss_falls(arch, chunked):
    """The Trainer on each smoke config (DeepSeek-V3 over LocalComm(4)),
    four steps of 8 x 16 tokens in 2 micro-batches on the CPU: every loss
    and gradient norm finite, the last loss below the first."""
    _, tcfg = cfgs(arch, microbatch=2)
    tr = Trainer(tcfg, TrainerConfig(steps=4, global_batch=8, seq_len=16, log_every=1),
                 comm=LocalComm(N) if arch == DS else None,
                 opt_cfg=AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=4), device="cpu")
    tr.data.batch_at = lambda step, first=tr.data.batch_at(0): first
    tr.run()
    losses = [r["loss"] for r in tr.metrics_log]
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert np.isfinite([r["gnorm"] for r in tr.metrics_log]).all()
    assert losses[-1] < losses[0], losses
