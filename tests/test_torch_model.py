"""The port's bigru model, weight carry-over and checkpoints against the JAX
package (``models/gru.py``, ``train/checkpoint.py``).  The same weights go
to both packages through ``models/params.py``; the port runs the plain GRU
layer on the CPU."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_video_action_tpu.models import gru as jgru
from pytorch_video_action_tpu.ops import hashmask as jhash
from pytorch_video_action_tpu.train import checkpoint as jckpt
from pytorch_video_action_tpu_torch.models import build_model
from pytorch_video_action_tpu_torch.models.gru import BiGRU, BiGRUConfig
from pytorch_video_action_tpu_torch.models.params import (from_jax_params,
                                                          to_jax_params)
from pytorch_video_action_tpu_torch.train import checkpoint as pckpt

CONFIGS = {
    "full": dict(n_class=48),
    "narrow": dict(gru_layer=2, hidden_dim_1=32, n_class=7),  # H=16
}


def _setup(name, seed=0, b=3, t=40):
    kw = CONFIGS[name]
    jcfg = jgru.BiGRUConfig(**kw)
    params = jgru.init(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree.map(np.asarray, params)
    model = BiGRU(BiGRUConfig(**kw))
    model.load_state_dict(from_jax_params("bigru", tree))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, 400)).astype(np.float32)
    lengths = np.array([t, t // 2 + 3, 1][:b], np.int32)
    return jcfg, params, tree, model, x, lengths


def _valid(lengths, t):
    return np.arange(t)[None, :] < lengths[:, None]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_bigru_logprobs_match_jax(name):
    jcfg, params, _, model, x, lengths = _setup(name)
    want = np.asarray(jgru.apply(params, jcfg, jnp.asarray(x),
                                 jnp.asarray(lengths), train=False))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(lengths)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    m = _valid(lengths, x.shape[1])
    np.testing.assert_allclose(got[m], want[m], atol=1e-4, rtol=0)
    # padded frames: both give log_softmax(bias), the masked stream's output
    np.testing.assert_allclose(got[~m], want[~m], atol=1e-4, rtol=0)


def test_bigru_dropout_matches_jax_with_shared_seeds():
    """train=True with the JAX package's dropout seeds handed over as uint32
    values: input dropout plus the strided inter-layer masks."""
    jcfg, params, _, model, x, lengths = _setup("narrow", seed=1)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jgru.apply(params, jcfg, jnp.asarray(x),
                                 jnp.asarray(lengths), train=True, rng=key))
    r_in, r_rnn = jax.random.split(key, 2)
    seeds = [int(jhash.rng_seed_u32(r_in))]
    for _ in range(jcfg.gru_layer - 1):
        r_rnn, sub = jax.random.split(r_rnn)
        seeds.append(int(jhash.rng_seed_u32(sub)))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(lengths),
                    train=True, seeds=seeds).numpy()
        off = model(torch.from_numpy(x), torch.from_numpy(lengths)).numpy()
    m = _valid(lengths, x.shape[1])
    np.testing.assert_allclose(got[m], want[m], atol=1e-4, rtol=0)
    assert np.abs(got[m] - off[m]).max() > 1e-2  # dropout really ran


def test_train_forward_needs_seeds():
    model = BiGRU(BiGRUConfig(**CONFIGS["narrow"]))
    with pytest.raises(ValueError, match="seeds"):
        model(torch.zeros(1, 4, 400), torch.tensor([4]), train=True)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_params_round_trip(name):
    _, _, tree, model, _, _ = _setup(name, seed=2)
    back = to_jax_params("bigru", from_jax_params("bigru", tree))
    flat_a = jckpt._flatten(tree)
    flat_b = jckpt._flatten(back)
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        assert np.array_equal(flat_a[k], flat_b[k])
    assert set(model.state_dict()) == {k.replace("/", ".") for k in flat_a}


def test_jax_checkpoint_loads_in_port(tmp_path):
    _, params, tree, _, _, _ = _setup("full", seed=3)
    path = os.path.join(tmp_path, "bigru_12.34_dev.npz")
    jckpt.save_params(path, params)
    got = jckpt._flatten(pckpt.load_params(path))
    want = jckpt._flatten(tree)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k], want[k])


def test_port_checkpoint_loads_in_jax(tmp_path):
    model = build_model("bigru", 48, generator=torch.Generator().manual_seed(4))
    tree = to_jax_params("bigru", model.state_dict())
    path = os.path.join(tmp_path, pckpt.checkpoint_name("bigru", 56.789))
    pckpt.save_params(path, tree)
    assert os.path.exists(path + ".npz") and path.endswith("bigru_56.79_dev")
    got = jckpt._flatten(jckpt.load_params(path + ".npz"))
    want = jckpt._flatten(tree)
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(np.asarray(got[k]), want[k])


@pytest.mark.parametrize("name,flags", [
    ("simple_fc", {}), ("simple_fc", {"defaults": True}), ("ctcloss", {})])
def test_unported_models_name_their_roadmap_item(name, flags):
    """simple_fc and ctcloss, the two families ROADMAP item 12 named, are
    ported: each builds its class (ctcloss: the BiGRU with the CTC blank
    as one more class), and only an unknown name raises."""
    from pytorch_video_action_tpu_torch.models.simple_fc import SimpleFC

    model = build_model(name, 48, **flags)
    assert model.name == name and model.n_dropout_sites >= 0
    if name == "simple_fc":
        assert isinstance(model, SimpleFC) and model.cfg.n_class == 48
        assert [model.fc1.w.shape[0], *(getattr(model, f"fc{i}").w.shape[1]
                                        for i in range(1, 5))] == [
            400, 256, 128, 32, 48]
    else:
        assert isinstance(model, BiGRU) and model.cfg.n_class == 49
    with pytest.raises(NotImplementedError, match="unknown model"):
        build_model("no_such_model", 48, **flags)


def test_mstcn_builds_with_the_inference_defaults():
    from pytorch_video_action_tpu_torch.models.mstcn import MSTCN

    model = build_model("mstcn", 48, defaults=True)
    assert isinstance(model, MSTCN)
    assert (model.cfg.dim, model.cfg.num_stages, model.cfg.num_layers,
            model.cfg.num_f_maps, model.cfg.n_class) == (400, 4, 20, 64, 48)
