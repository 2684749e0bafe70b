"""The port's tagged-tensor surface (``core/tensor.py``,
``ep_dispatch_tensors`` / ``ep_combine_tensors``) and the unified API's
property tests, as ``tests/test_ep_unified.py`` states them for the JAX
package, over ``LocalComm(8)``.

The tagged entry points must give what ``ep_dispatch`` / ``ep_combine``
give on the same inputs, bit for bit, and refuse a wrong tag, dtype or rank
with ``ValueError`` as the reference's ``validate`` does; the tag enum and
the dtypes each tag allows are the reference's. The property tests draw
routings with hypothesis (the reference's ``max_examples``): identity
experts under normalised weights give back the input, and every (t, k)
entry is delivered once, in every mode; permuting a rank's tokens permutes
its output (LL).
"""
import numpy as np
import pytest
import torch

hypothesis = pytest.importorskip(
    "hypothesis", reason="property tests need hypothesis (see requirements-dev.txt)")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import tensor as jtensor  # noqa: E402
from repro_torch.comm import LocalComm  # noqa: E402
from repro_torch.core import (EpGroupConfig, EpTensor, EpTensorTag, ep_combine,  # noqa: E402
                              ep_combine_tensors, ep_create_group, ep_create_handle,
                              ep_dispatch, ep_dispatch_tensors, ep_tensor_create)
from repro_torch.core.tensor import as_array, validate  # noqa: E402

N = 8


def mk(rng, n, t, k, e, h):
    x = rng.standard_normal((n, t, h)).astype(np.float32)
    topk = np.stack([np.stack([rng.choice(e, k, replace=False) for _ in range(t)])
                     for _ in range(n)]).astype(np.int32)
    logits = rng.standard_normal((n, t, k)).astype(np.float32)
    w = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return x, topk, w.astype(np.float32)


def group_and_handles(mode, x, topk, w, **kw):
    n, t, h = x.shape
    cfg = EpGroupConfig(num_experts=kw.pop("e"), max_tokens_per_rank=t, hidden=h,
                        top_k=topk.shape[-1], mode=mode, payload_dtype=torch.float32, **kw)
    group = ep_create_group(cfg, LocalComm(n))
    hs = ep_create_handle(group, [torch.from_numpy(a) for a in topk],
                          [torch.from_numpy(a) for a in w])
    return group, hs


@pytest.mark.parametrize("mode", ["ll", "ht", "baseline"])
def test_tagged_tensor_surface(mode):
    """Tags of the outputs, and bitwise equality with the untagged calls."""
    x, topk, w = mk(np.random.default_rng(1), N, 8, 2, 8, 16)
    group, hs = group_and_handles(mode, x, topk, w, e=8)
    xs = [torch.from_numpy(a) for a in x]
    outs = ep_dispatch_tensors(group, hs, [[EpTensor(a, EpTensorTag.TOKENS)] for a in xs])
    want = ep_dispatch(group, hs, xs)
    for (y_t, c_t), (y, c) in zip(outs, want):
        assert y_t.tag == EpTensorTag.TOKENS and c_t.tag == EpTensorTag.TOKENS_PER_EXPERTS
        assert torch.equal(y_t.data, y) and torch.equal(c_t.data, c)
    assert sum(int(c_t.data.sum()) for _, c_t in outs) == N * 8 * 2
    ys = [y for y, _ in want]
    comb = ep_combine_tensors(group, hs, [[ep_tensor_create(y, EpTensorTag.TOKENS)] for y in ys])
    for o_t, o in zip(comb, ep_combine(group, hs, ys)):
        assert o_t.tag == EpTensorTag.TOKENS and torch.equal(o_t.data, o)
    # a raw tensor passes validate untagged, as the reference's does
    assert as_array(comb[0]) is comb[0].data and validate(xs[0], tag=EpTensorTag.TOKENS) is xs[0]


def test_wrong_tag_rejected():
    t = EpTensor(torch.zeros((4, 4)), EpTensorTag.TOPK_WEIGHTS)
    with pytest.raises(ValueError):
        validate(t, tag=EpTensorTag.TOKENS)


def test_wrong_dtype_rank_or_missing_tokens_rejected():
    x, topk, w = mk(np.random.default_rng(2), N, 8, 2, 8, 16)
    group, hs = group_and_handles("ll", x, topk, w, e=8)
    bad = {
        "dtype": [[EpTensor(torch.from_numpy(a).to(torch.float64), EpTensorTag.TOKENS)] for a in x],
        "rank": [[EpTensor(torch.from_numpy(a)[None], EpTensorTag.TOKENS)] for a in x],
        "tag": [[EpTensor(torch.from_numpy(a), EpTensorTag.SCALES)] for a in x],
    }
    for name, inputs in bad.items():
        with pytest.raises(ValueError):
            ep_dispatch_tensors(group, hs, inputs)
    with pytest.raises(ValueError, match="TOPK_IDX"):
        validate(torch.zeros((4, 2), dtype=torch.int64), tag=EpTensorTag.TOPK_IDX)
    with pytest.raises(ValueError, match="rank 3"):
        ep_combine_tensors(group, hs, [[EpTensor(torch.zeros((4, 16)), EpTensorTag.TOKENS)]] * N)


def test_tags_and_dtypes_match_reference():
    assert [t.name for t in EpTensorTag] == [t.name for t in jtensor.EpTensorTag]
    assert [t.value for t in EpTensorTag] == [t.value for t in jtensor.EpTensorTag]
    from repro_torch.core import tensor as ttensor
    for tag, jdts in jtensor._ALLOWED_DTYPES.items():
        tdts = ttensor._ALLOWED_DTYPES[EpTensorTag[tag.name]]
        assert [str(d).removeprefix("torch.") for d in tdts] == [np.dtype(d).name for d in jdts]


# ---------------------------------------------------------------------------
# property-based invariants (tests/test_ep_unified.py:112, :139)
# ---------------------------------------------------------------------------

@settings(max_examples=12, deadline=None)
@given(
    seed=st.integers(0, 2**16),
    mode=st.sampled_from(["ll", "ht", "baseline"]),
    ek=st.sampled_from([(8, 2), (16, 4), (32, 8), (8, 8)]),
    t=st.sampled_from([4, 8, 24]),
)
def test_property_roundtrip_and_conservation(seed, mode, ek, t):
    """Identity experts under weights that sum to 1 give back the input, and
    every (t, k) entry is delivered exactly once."""
    e, k = ek
    x, topk, w = mk(np.random.default_rng(seed), N, t, k, e, 16)
    group, hs = group_and_handles(mode, x, topk, w, e=e)
    recv = ep_dispatch(group, hs, [torch.from_numpy(a) for a in x])
    out = ep_combine(group, hs, [y for y, _ in recv])
    np.testing.assert_allclose(np.stack([o.numpy() for o in out]), x, rtol=2e-5, atol=2e-5)
    assert sum(int(c.sum()) for _, c in recv) == N * t * k


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 2**16))
def test_property_permutation_equivariance(seed):
    """Permuting tokens within a rank permutes its output the same way (LL)."""
    e, k, t = 16, 4, 8
    rng = np.random.default_rng(seed)
    x, topk, w = mk(rng, N, t, k, e, 16)
    perm = rng.permutation(t)

    def run(x, topk, w):
        group, hs = group_and_handles("ll", x, topk, w, e=e)
        L = group.local_experts
        recv = ep_dispatch(group, hs, [torch.from_numpy(a) for a in x])
        ys = [y * (1.0 + torch.arange(r * L, (r + 1) * L)).float()[:, None, None]
              for r, (y, _) in enumerate(recv)]
        return np.stack([o.numpy() for o in ep_combine(group, hs, ys)])

    out1 = run(x, topk, w)
    out2 = run(np.ascontiguousarray(x[:, perm]), np.ascontiguousarray(topk[:, perm]),
               np.ascontiguousarray(w[:, perm]))
    np.testing.assert_allclose(out1[:, perm], out2, rtol=2e-5, atol=2e-5)
