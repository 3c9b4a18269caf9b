"""The port's entry points (``super_rag_tpu_torch/entry.py``) against the
JAX package's ``__graft_entry__.py``: the flagship forward on the same
parameters and ids, within ``tests/test_torch_encoder.py``'s bf16 score
tolerance; and ``dryrun_multichip`` on gloo ranks on the CPU, every one
of its asserts (growth across a capacity class, deletes, a filter that
zeroes a whole shard, IVF at full probe equal to flat, and at four ranks
the multislice mesh equal to the gold)."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from super_rag_tpu.models.encoder import EncoderConfig as JConfig
from super_rag_tpu.models.encoder import TextEncoder as JEncoder
from super_rag_tpu_torch import entry as tentry

# bf16 activations round every product in other places (test_torch_encoder)
BF16_SCORE_TOL = 2e-2


def test_entry_forward_matches_jax():
    jfn, jargs = jentry.entry()
    want = np.asarray(jax.jit(jfn)(*jargs), np.float32)
    cfg = JConfig(**tentry.FLAGSHIP, dtype=jax.numpy.bfloat16)
    params = jax.tree.map(lambda a: np.asarray(a, np.float32),
                          JEncoder(cfg).init_params(jax.random.PRNGKey(0)))
    fn, args = tentry.entry(device="cpu", params=params)
    np.testing.assert_array_equal(args[0].numpy(), np.asarray(jargs[0]))
    np.testing.assert_array_equal(args[1].numpy(), np.asarray(jargs[1]))
    got = fn(*args).numpy()
    assert got.shape == want.shape == (16, 256)
    np.testing.assert_array_less(np.abs(got - want), BF16_SCORE_TOL * (1.0 + np.abs(want)))
    # unit rows, each pointing where the JAX row points
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)
    assert (np.sum(got * want, axis=1) > 0.999).all()


def test_entry_draws_its_own_weights_from_a_seed():
    fn, args = tentry.entry(device="cpu")
    a, b = fn(*args), fn(*args)
    assert a.dtype == torch.float32 and tuple(a.shape) == (16, 256)
    assert torch.equal(a, b) and torch.isfinite(a).all()
    fn2, _ = tentry.entry(device="cpu")
    assert torch.equal(fn2(*args), a)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_on_gloo_ranks(n):
    tentry.dryrun_multichip(n, device="cpu", timeout_s=180)


def test_dryrun_refuses_nccl_past_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="one rank per card"):
        tentry.dryrun_multichip(2, device="cuda", backend="nccl")
