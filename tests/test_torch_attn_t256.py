"""attn at padded T = 256, the one length where JAX's own float32 train step
stands apart: the port's float32 step held against JAX's in float64.

One attn train step (dense attention path: ``BLOCKWISE_MIN_T`` left at
1024; two videos of 256 and 150 frames; dropout on with the JAX seed), as
``test_torch_flash_bthd.py::test_attn_under_the_flag_matches_jax`` runs it
at T = 320.  At T = 256 JAX's jitted float32 gradients of the GRU's forward
direction stand some 3.6e-2 off both the port's float32 step and JAX's own
float64 step, while the port's float32 step agrees with JAX's float64 step
to about 5e-7 (ROADMAP.md §3, "Reference behaviour the port keeps").  JAX
runs in float64 inside ``jax.enable_x64``, so the worker's other tests keep
float32.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from pytorch_video_action_tpu.models import build_model as jbuild
from pytorch_video_action_tpu.ops import hashmask as jhash
from pytorch_video_action_tpu.train import checkpoint as jckpt
from pytorch_video_action_tpu_torch.models import build_model
from pytorch_video_action_tpu_torch.models.params import from_jax_params

N_CLASS = 7


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


def test_attn_at_t256_matches_jax_in_float64():
    """Log-probs on valid frames and every gradient of the port's float32
    step against JAX's float64 step, 5e-6."""
    mdef = jbuild("attn", N_CLASS)
    params = mdef.init(jax.random.PRNGKey(1))
    model = build_model("attn", N_CLASS)
    model.load_state_dict(from_jax_params("attn", jax.tree.map(np.asarray,
                                                               params)))
    t = 256
    rng = np.random.default_rng(3)
    lengths = np.array([t, 150], np.int32)
    x = rng.normal(size=(2, t, 400)).astype(np.float32)
    x[np.arange(t)[None, :] >= lengths[:, None]] = 0.0
    valid = np.arange(t)[None, :] < lengths[:, None]
    cot = rng.normal(size=(2, t, N_CLASS)).astype(np.float32) * valid[
        :, :, None]
    key = jax.random.PRNGKey(9)

    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        x64 = jnp.asarray(x, jnp.float64)

        def jf(p):
            out = mdef.apply(p, x64, jnp.asarray(lengths), train=True,
                             rng=key)
            return jnp.sum(out * cot.astype(np.float64)), out

        (_, want), jgrads = jax.jit(jax.value_and_grad(jf, has_aux=True))(
            p64)
        want = np.asarray(want)
        flat = {k: np.asarray(v) for k, v in jckpt._flatten(jgrads).items()}
    # the model's last log_softmax casts to float32 (models/common.py), so
    # the log-probs are float64 values rounded once; every gradient is
    # float64
    assert all(g.dtype == np.float64 for g in flat.values())
    seed = int(jhash.rng_seed_u32(jax.random.split(key, 2)[0]))
    out = model(torch.from_numpy(x), torch.from_numpy(lengths), train=True,
                seeds=[seed])
    (out * torch.from_numpy(cot)).sum().backward()
    assert out.dtype == torch.float32
    assert _rel_err(out.detach().numpy()[valid], want[valid]) <= 5e-6
    for k, p in model.named_parameters():
        assert _rel_err(p.grad.numpy(), flat[k.replace(".", "/")]) <= 5e-6, k
