"""Four faults of the port against the JAX package, each with the input
that showed it:

1. ``infer/loader.py::load_models`` on a checkpoint that is not a valid
   npz: the JAX loader prints the error and skips the model; the port's
   raised.
2. The bidirectional LSTM stack at a width the fused layer kernel does not
   take (``--lstm_hidden1 96`` and ``512``: H = 48 and 256): the port now
   runs the LSTM scan there, as JAX's per-layer fallback does.  Forward
   and gradients against JAX on the CPU.
3. attn at ``--attn_head`` 2 and 1 (d = 200 and 400) on the flash path
   (padded T >= 1024): the port's flash kernels took d <= 128.  Forward and
   gradients against JAX on the CPU; the kernels at those widths are held
   against their plain versions in ``test_torch_cuda_kernels.py``.
4. ``ops/hashmask.py::hash_dropout`` in bf16: JAX rounds the scale
   ``1 / keep`` to bf16 before the product (a weakly typed scalar), the
   port multiplied by the f32 scale and rounded after it.  At keep 0.7 one
   output in eight differed by an ulp.
6. ``data/features.py``: a stale or corrupt feature cache (here an object
   array whose pickle names a module that no longer imports, which raises
   ``ModuleNotFoundError``) made the port's ``load_cached`` and
   ``VideoDataset`` raise, where JAX's catch ``Exception`` and re-parse the
   gz files; ``save_cache`` likewise raised on what it could not pickle,
   where JAX's prints its warning.

f32: 1e-5 of each tensor's largest element (at least 1), the same sums in
another order.
"""

import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_video_action_tpu.data import features as jfeat
from pytorch_video_action_tpu.data.dataset import VideoDataset as JVideoDataset
from pytorch_video_action_tpu.infer import loader as jloader
from pytorch_video_action_tpu.models import build_model as jbuild
from pytorch_video_action_tpu.ops import hashmask as jhash
from pytorch_video_action_tpu.train import checkpoint as jckpt
from pytorch_video_action_tpu_torch.data import features as pfeat
from pytorch_video_action_tpu_torch.data.dataset import VideoDataset
from pytorch_video_action_tpu_torch.infer import loader as ploader
from pytorch_video_action_tpu_torch.models import build_model
from pytorch_video_action_tpu_torch.models.params import from_jax_params
from pytorch_video_action_tpu_torch.ops import hashmask as PH
from pytorch_video_action_tpu_torch.ops import rnn as PR
from pytorch_video_action_tpu_torch.ops import rnn_scan as RS

N_CLASS = 7
TOL = 1e-5


# ------------------------------------------------------------ 1. the loader


def _bad_checkpoint(path, kind):
    if kind == "not_npz":
        path.write_bytes(b"these bytes are no checkpoint\n" * 4)
    else:  # a valid npz cut in half
        jckpt.save_params(str(path), jbuild("bigru", 48, defaults=True)
                          .init_params(jax.random.PRNGKey(0)))
        data = path.read_bytes()
        path.write_bytes(data[:len(data) // 2])


@pytest.mark.parametrize("kind", ["not_npz", "truncated"])
def test_unreadable_checkpoint_is_skipped_as_in_jax(tmp_path, capsys, kind):
    _bad_checkpoint(tmp_path / "bigru_12.34_dev.npz", kind)
    args = (["bigru_12.34_dev"], 48)
    assert jloader.load_models(*args, models_dir=str(tmp_path)) == {}
    want = capsys.readouterr().out
    assert ploader.load_models(*args, models_dir=str(tmp_path),
                               device="cpu") == {}
    got = capsys.readouterr().out
    skip = f"Model bigru_12.34_dev not found in {tmp_path}/bigru_12.34_dev.npz!"
    assert skip in want.splitlines() and skip in got.splitlines()
    assert got.splitlines()[-1] == want.splitlines()[-1] == skip


# ------------------------------------------- 2. the LSTM stack at any width


def _pair(name, seed, n_class=N_CLASS, **flags):
    mdef = jbuild(name, n_class, **flags)
    init = mdef.init(jax.random.PRNGKey(seed))
    params, state = init if mdef.stateful else (init, None)
    model = build_model(name, n_class, **flags)
    model.load_state_dict(from_jax_params(
        name, jax.tree.map(np.asarray, params),
        None if state is None else jax.tree.map(np.asarray, state)))
    return mdef, params, state, model


def _batch(seed, b=3, t=24):
    rng = np.random.default_rng(seed)
    lengths = np.array([t, t // 2 + 1, 1][:b], np.int32)
    x = rng.normal(size=(b, t, 400)).astype(np.float32)
    x[np.arange(t)[None, :] >= lengths[:, None]] = 0.0
    return x, lengths


def _lstm_seeds(name, key, n_layers):
    """The dropout seeds of one JAX forward (models/lstm.py, rnn.py:522)."""
    keys = jax.random.split(key, 3 if name == "bilstm" else 2)
    seeds = [int(jhash.rng_seed_u32(keys[0]))]
    r_rnn = keys[1]
    for _ in range(n_layers - 1):
        r_rnn, sub = jax.random.split(r_rnn)
        seeds.append(int(jhash.rng_seed_u32(sub)))
    if name == "bilstm":
        seeds.append(int(jhash.rng_seed_u32(keys[2])))
    return seeds


def _close(got, want, what):
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err <= TOL, (what, err)


@pytest.mark.parametrize("hidden1", [96, 512])
@pytest.mark.parametrize("name", ["bilstm", "bilstm_lm"])
def test_bilstm_at_widths_the_fused_kernel_does_not_take(monkeypatch, name,
                                                         hidden1):
    """Train form (dropout on, the JAX seeds): log-probs on valid frames
    and the gradients of a cotangent over them, through the LSTM scan (its
    saving forward and saved-gates backward, both directions of both
    layers), never the fused layer."""
    calls = []
    monkeypatch.setattr(PR, "lstm_bidir_layer",
                        lambda *a: calls.append("fused"))
    scan = RS.lstm_scan_fwd_save
    monkeypatch.setattr(RS, "lstm_scan_fwd_save",
                        lambda *a: calls.append("scan") or scan(*a))
    flags = dict(lstm_layer=2, lstm_hidden1=hidden1, lstm_hidden2=16)
    mdef, params, state, model = _pair(name, 3, **flags)
    x, lengths = _batch(4)
    valid = np.arange(24)[None, :] < lengths[:, None]
    cot = np.random.default_rng(5).normal(size=(3, 24, N_CLASS)).astype(
        np.float32) * valid[:, :, None]
    key = jax.random.PRNGKey(6)

    def jf(p):
        if mdef.stateful:
            out, _ = mdef.apply(p, jnp.asarray(x), jnp.asarray(lengths),
                                train=True, rng=key, state=state)
        else:
            out = mdef.apply(p, jnp.asarray(x), jnp.asarray(lengths),
                             train=True, rng=key)
        return jnp.sum(out * cot), out

    (_, want), jgrads = jax.value_and_grad(jf, has_aux=True)(params)
    out = model(torch.from_numpy(x), torch.from_numpy(lengths), train=True,
                seeds=_lstm_seeds(name, key, 2))
    (out * torch.from_numpy(cot)).sum().backward()
    assert calls == ["scan"] * 4
    _close(out.detach().numpy()[valid], np.asarray(want)[valid], "log-probs")
    jgrads = {k: np.asarray(v) for k, v in jckpt._flatten(jgrads).items()}
    for k, p in model.named_parameters():
        _close(p.grad.numpy(), jgrads[k.replace(".", "/")], k)


# ------------------------------------------------ 3. attn at d = 200 and 400


@pytest.mark.parametrize("heads", [2, 1])
def test_attn_wide_heads_on_the_flash_path_match_jax(heads):
    """Padded T = 1024 (the flash path in both packages), dropout on with
    the JAX seed: log-probs on valid frames and every gradient."""
    mdef, params, _, model = _pair("attn", 1, attn_head=heads)
    t = 1024
    x, lengths = _batch(7, b=2, t=t)
    lengths = np.array([t, 700], np.int32)
    valid = np.arange(t)[None, :] < lengths[:, None]
    cot = np.random.default_rng(8).normal(size=(2, t, N_CLASS)).astype(
        np.float32) * valid[:, :, None]
    key = jax.random.PRNGKey(9)

    def jf(p):
        out = mdef.apply(p, jnp.asarray(x), jnp.asarray(lengths), train=True,
                         rng=key)
        return jnp.sum(out * cot), out

    (_, want), jgrads = jax.jit(jax.value_and_grad(jf, has_aux=True))(params)
    seed = int(jhash.rng_seed_u32(jax.random.split(key, 2)[0]))
    out = model(torch.from_numpy(x), torch.from_numpy(lengths), train=True,
                seeds=[seed])
    (out * torch.from_numpy(cot)).sum().backward()
    _close(out.detach().numpy()[valid], np.asarray(want)[valid], "log-probs")
    jgrads = {k: np.asarray(v) for k, v in jckpt._flatten(jgrads).items()}
    for k, p in model.named_parameters():
        _close(p.grad.numpy(), jgrads[k.replace(".", "/")], k)


# ------------------------------------------- 4. the bf16 dropout scale


def test_bf16_dropout_scale_matches_jax():
    """The same seed, shape and keep 0.7 through both packages'
    ``hash_dropout`` in bf16: bit-equal outputs (the scale 1/0.7 rounds to
    bf16's 1.4296875 first in both)."""
    key = jax.random.PRNGKey(11)
    x = np.random.default_rng(12).normal(size=(8, 512)).astype(np.float32)
    want = jhash.hash_dropout(key, jnp.asarray(x, jnp.bfloat16), 0.7)
    got = PH.hash_dropout(int(jhash.rng_seed_u32(key)),
                          torch.from_numpy(x).to(torch.bfloat16), 0.7)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(),
                          np.asarray(want.astype(jnp.float32)))


# ------------------------------------------- 6. the feature cache


def _stale_cache(path):
    """An object-array ``.npy`` whose pickle names a module that is gone:
    loading it raises ``ModuleNotFoundError``."""
    name = "pva_feature_cache_gone"
    mod = types.ModuleType(name)

    class Feature:
        pass

    Feature.__module__ = name
    Feature.__qualname__ = "Feature"
    mod.Feature = Feature
    sys.modules[name] = mod
    try:
        obj = np.empty(2, dtype=object)
        obj[0], obj[1] = Feature(), Feature()
        np.save(path, obj, allow_pickle=True)
    finally:
        del sys.modules[name]
    with pytest.raises(ModuleNotFoundError):
        np.load(path, allow_pickle=True)


def test_stale_feature_cache_is_reparsed_as_in_jax(tmp_path, monkeypatch):
    """Both packages' ``load_cached`` return None on the stale cache, and
    both ``VideoDataset``s re-parse the gz files past it: equal features
    and labels."""
    from synthetic import make_synthetic_tree

    root = tmp_path / "ds"
    make_synthetic_tree(str(root), n_train=3, n_dev=2, n_test=2)
    stale = tmp_path / "stale.npy"
    _stale_cache(stale)
    assert jfeat.load_cached(str(stale)) is None
    assert pfeat.load_cached(str(stale)) is None
    kw = dict(data_dir=str(root / "data"), annot_path=str(root),
              part="dev", split=0, mode="active", verbose=False)
    got = {}
    for name, cls in (("jax", JVideoDataset), ("port", VideoDataset)):
        cache_dir = tmp_path / f"cache_{name}"
        cache_dir.mkdir()
        for kind in ("features", "labels"):
            _stale_cache(cache_dir / f"dev-0-{kind}.npy")
        got[name] = cls(cache_dir=str(cache_dir), **kw)
    assert len(got["port"].features) == len(got["jax"].features) == 2
    for a, b in zip(got["jax"].features, got["port"].features):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got["jax"].labels, got["port"].labels):
        np.testing.assert_array_equal(a, b)


def test_unpicklable_feature_cache_warns_as_in_jax(tmp_path, capsys):
    """``save_cache`` of what pickle refuses (a local function) prints
    JAX's warning in both packages and raises in neither."""
    def local():
        pass

    for feat in (jfeat, pfeat):
        feat.save_cache(str(tmp_path / "x.npy"), [np.zeros(3), local])
        assert "[WARNING] Failed to save data cache" in capsys.readouterr().out
