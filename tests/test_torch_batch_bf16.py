"""Training on a batch of samples in bfloat16 (``compute_dtype bfloat16``)
against the JAX package's bf16 step on the CPU: B = 2 and 3, and B = 4 in
two microbatches, at the bf16 train bounds of tests/test_torch_bf16.py,
each also nearer JAX bf16 on average than JAX float32 is
(tests/_torch_batch_setup.py)."""

import pytest

import _torch_batch_setup as S


@pytest.fixture(scope="module")
def scene():
    return S.Scene()


@pytest.mark.parametrize("b,accum", [(2, 1), (3, 1), (4, 2)])
def test_batch_step_matches_jax_bf16(scene, b, accum):
    """Loss, gradients and the first Adam update of one bf16 step, jitter
    off, raw_noise_std 0; the JAX bf16 pipeline culls in float32 as the
    port does."""
    jb, ts = scene.samples(b)
    ref32 = S.jax_step(scene, scene.jax_pipe(), jb, accum)
    with S.as_written():
        ref16 = S.jax_step(scene, scene.jax_pipe("bfloat16"), jb, accum)
    port = S.port_step(scene, scene.port_pipe("bfloat16"), ts, accum)
    S.check_bf16(port, ref16, ref32, S.leaves(scene.params["params"]))
