"""The port's Trainer at smoke sizes on the CPU, mirroring tests/test_runtime.py.

The data pipeline's determinism and resume; the loss falling through the EP
dispatch and combine over ``LocalComm(4)``; a run interrupted by a
checkpoint and resumed equal to the uninterrupted run bit for bit;
``params_physical`` refused with the reference's message; a port
checkpoint restored by the reference's ``restore_checkpoint`` with its specs
and a reference Trainer's checkpoint restored by the port's, every value
bitwise; the parameters a run returns served as they are (the step marks
none of them as requiring grad); the launcher's command line.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import latest_step as j_latest_step
from repro.checkpoint import restore_checkpoint as j_restore
from repro.configs import get_smoke as j_get_smoke
from repro.models import get_model as j_get_model
from repro.optim import AdamWConfig as JAdamW
from repro.optim import adamw_init_specs as j_adamw_init_specs
from repro.runtime.trainer import Trainer as JTrainer
from repro.runtime.trainer import TrainerConfig as JTrainerConfig
from repro_torch.comm import LocalComm
from repro_torch.configs import get_smoke
from repro_torch.data import DataConfig, DataPipeline
from repro_torch.launch import train as launch_train
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.server import DecodeServer
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.checkpoint.store import _flatten


def _leaves(tree):
    return _flatten(tree)[0]


def _bits(t) -> np.ndarray:
    """A leaf's values as exact bits, whatever its type or package."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().copy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def test_data_pipeline_deterministic_and_resumable():
    cfg = DataConfig(vocab=100, seq_len=16, global_batch=4, microbatch=2, seed=7)
    p1 = DataPipeline(cfg)
    batches = [next(p1) for _ in range(5)]
    assert batches[0]["tokens"].shape == (2, 2, 16)
    assert batches[0]["tokens"].dtype == torch.int32
    assert torch.equal(batches[0]["tokens"][..., 1:], batches[0]["targets"][..., :-1])
    p2 = DataPipeline(cfg)
    p2.restore(dict(step=3, seed=7))
    assert torch.equal(next(p2)["tokens"], batches[3]["tokens"])
    assert torch.equal(p1.batch_at(1)["tokens"], batches[1]["tokens"])
    assert not torch.equal(batches[0]["tokens"], batches[1]["tokens"])
    other = DataPipeline(dataclasses.replace(cfg, seed=8))
    assert not torch.equal(other.batch_at(0)["tokens"], batches[0]["tokens"])
    with pytest.raises(AssertionError, match="seed mismatch"):
        other.restore(p1.state())
    # the reference's Zipf-like unigram: rank 1 is the most frequent token
    big = DataPipeline(DataConfig(vocab=100, seq_len=512, global_batch=8)).batch_at(0)
    freq = torch.bincount(big["tokens"].reshape(-1).long(), minlength=100)
    assert int(freq.argmax()) == 0 and freq[0] > 4 * freq[9]


def _hot_opt(steps):
    return AdamWConfig(lr=5e-3, warmup_steps=2, total_steps=steps, weight_decay=0.0)


def test_train_loss_decreases_moe_ep():
    """DBRX's smoke config trained through the HT flat dispatch and combine
    over LocalComm(4) (every rank's rows through the exchange)."""
    cfg = get_smoke("dbrx-132b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, ep_mode="ht"))
    t = Trainer(cfg, TrainerConfig(steps=20, global_batch=8, seq_len=32, log_every=5),
                comm=LocalComm(4), opt_cfg=_hot_opt(20), device="cpu")
    t.run()
    losses = [m["loss"] for m in t.metrics_log]
    assert len(losses) == 4 and losses[-1] < losses[0] - 0.3, losses


def test_trainer_resume_matches_uninterrupted(tmp_path):
    """Checkpoint at step 3, a new Trainer resumes to 6: parameters and
    AdamW state bitwise those of 6 uninterrupted steps."""
    cfg = dataclasses.replace(get_smoke("dbrx-132b"), microbatch=2)
    base = dict(global_batch=4, seq_len=16, log_every=3, ckpt_every=3)
    opt = _hot_opt(6)
    comm = LocalComm(2)
    p1, o1 = Trainer(cfg, TrainerConfig(steps=6, **base), comm, opt, "cpu").run()
    Trainer(cfg, TrainerConfig(steps=3, ckpt_dir=str(tmp_path), **base), comm, opt,
            "cpu").run()
    t3 = Trainer(cfg, TrainerConfig(steps=6, ckpt_dir=str(tmp_path), **base), comm, opt, "cpu")
    p3, o3 = t3.run()
    assert t3.data.step == 6
    for (pa, a), (pb, b) in zip(_leaves((p1, o1)), _leaves((p3, o3))):
        assert pa == pb and np.array_equal(_bits(a), _bits(b)), pa


def test_trainer_rejects_physical_params():
    cfg = get_smoke("dbrx-132b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, params_physical=True))
    with pytest.raises(ValueError, match="serving-only layout; train with "
                                         r"params_physical=False \(logical expert weights\)"):
        Trainer(cfg, TrainerConfig(steps=1, global_batch=4, seq_len=8), device="cpu")


def _tree_leaves(tree):
    """(path, leaf) of a (params, opt, data-state) tree in flatten order."""
    return [(tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path), v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_checkpoints_interoperate_with_the_reference(tmp_path):
    """A port Trainer's checkpoint restored by the reference's
    restore_checkpoint with its specs, and a reference Trainer's restored by
    the port's ``maybe_restore``: every parameter, moment, the step and
    the pipeline's state bitwise."""
    arch = "dbrx-132b"
    tcfg = TrainerConfig(steps=2, global_batch=4, seq_len=16, ckpt_dir=str(tmp_path / "port"))
    params, opt = Trainer(get_smoke(arch), tcfg, device="cpu").run()
    jcfg = j_get_smoke(arch)
    pspec = j_get_model(jcfg).params_spec(jcfg)
    ospec = j_adamw_init_specs(pspec, JAdamW())
    target = (pspec, ospec, dict(step=np.zeros((), np.int64), seed=np.zeros((), np.int64)))
    step = j_latest_step(tmp_path / "port")
    assert step == 2
    (jp, jo, ds), _ = j_restore(tmp_path / "port", step, target)
    assert int(ds["step"]) == 2 and int(ds["seed"]) == 0
    got = _tree_leaves((jp, jo))
    mine = list(_leaves((params, opt)))
    assert len(got) == len(mine)
    for (pa, a), (pb, b) in zip(got, mine):
        assert np.array_equal(_bits(a), _bits(b)), pa
    # the other way round
    jtcfg = JTrainerConfig(steps=2, global_batch=4, seq_len=16,
                           ckpt_dir=str(tmp_path / "ref"))
    jparams, jopt = JTrainer(jcfg, jtcfg).run()
    t = Trainer(get_smoke(arch), TrainerConfig(steps=2, global_batch=4, seq_len=16,
                                               ckpt_dir=str(tmp_path / "ref")), device="cpu")
    rp, ro = t.maybe_restore()
    assert t.data.step == 2
    for (pa, a), (pb, b) in zip(_tree_leaves((jparams, jopt)), _leaves((rp, ro))):
        assert np.array_equal(_bits(a), _bits(b)), pa


def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    t = launch_train.main(["--arch", "dbrx-132b", "--smoke", "--steps", "2",
                           "--global-batch", "4", "--seq", "16", "--ep", "2",
                           "--device", "cpu", "--ckpt", str(tmp_path)])
    assert t.data.step == 2 and isinstance(t.comm, LocalComm) and t.comm.size == 2
    assert t.device == torch.device("cpu")
    assert "resumed" not in capsys.readouterr().out
    t = launch_train.main(["--arch", "dbrx-132b", "--smoke", "--steps", "3",
                           "--global-batch", "4", "--seq", "16", "--device", "cpu",
                           "--ckpt", str(tmp_path)])
    assert "resumed at data step 2" in capsys.readouterr().out and t.data.step == 3


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.detach().clone()


def test_trained_parameters_serve_as_returned():
    """The train step differentiates detached copies of the parameters, so
    what ``Trainer.run`` returns keeps ``requires_grad`` off and a server
    streams the same tokens from it as from fresh copies of its values."""
    cfg = get_smoke("dbrx-132b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, ep_mode="ll"))
    params, opt = Trainer(cfg, TrainerConfig(steps=2, global_batch=4, seq_len=16),
                          comm=LocalComm(4), device="cpu").run()
    assert not any(t.requires_grad for _, t in _leaves((params, opt)))
    prompts = torch.randint(0, cfg.vocab, (4, 3), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(3))
    toks = []
    for p in (params, _clone(params)):
        srv = DecodeServer(cfg, 4, 8, ep_size=4, params=p, device="cpu")
        toks.append(srv.decode(srv.prefill(prompts)[0], 3)[0])
    assert np.array_equal(*toks)
