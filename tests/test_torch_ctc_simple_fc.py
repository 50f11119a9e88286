"""The last two families of the port, ctcloss and simple_fc
(``pytorch_video_action_tpu_torch/models/simple_fc.py``, the ctcloss build
in ``models/__init__.py``, ``train/losses.py``'s CTC and the ``Trainer``'s
CTC targets), against the JAX package.

The port runs on the CPU.  ctcloss's GRU layers run their plain PyTorch
versions, the JAX package its XLA path; the port's CTC negative
log-likelihood is torch's, the JAX package's optax's (plain XLA).
Parameters carry over with ``from_jax_params``; dropout seeds are the ones
the JAX step derives from its PRNG key.  torch's CPU CTC backward, which
crashed the reference (PARITY.md), survives here: the gradient checks run
on the CPU too.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_video_action_tpu.cli import inference_cli as jcli
from pytorch_video_action_tpu.models import ModelDef
from pytorch_video_action_tpu.models import build_model as jbuild
from pytorch_video_action_tpu.models import gru as jgru
from pytorch_video_action_tpu.ops import hashmask as jhash
from pytorch_video_action_tpu.train import checkpoint as jckpt
from pytorch_video_action_tpu.train import losses as jlosses
from pytorch_video_action_tpu.train.loop import Trainer as JTrainer
from pytorch_video_action_tpu_torch.cli import inference_cli as pcli
from pytorch_video_action_tpu_torch.models import build_model
from pytorch_video_action_tpu_torch.models.params import from_jax_params
from pytorch_video_action_tpu_torch.train import losses as plosses
from pytorch_video_action_tpu_torch.train.loop import Trainer

N_CLASS = 7
LR = 1e-3


def _labels(seed, b, t, lengths):
    """Frame labels with runs (so the collapse has work to do), -1 past
    each length."""
    rng = np.random.default_rng(seed)
    labels = np.repeat(rng.integers(0, N_CLASS, (b, t // 3 + 1)), 3,
                       axis=1)[:, :t]
    labels[np.arange(t)[None, :] >= np.asarray(lengths)[:, None]] = -1
    return labels


def test_prepare_ctc_targets_matches_jax():
    """Runs collapse, the padding drops out, an all-padding row gives an
    empty target, and the targets are zero-padded to the longest."""
    lengths = [24, 13, 0, 5]
    labels = _labels(0, 4, 24, lengths)
    labels[3, :5] = [2, 3, 2, 3, 2]  # collapses to itself
    got = plosses.prepare_ctc_targets(labels.reshape(-1), 4)
    want = jlosses.prepare_ctc_targets(labels.reshape(-1), 4)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got[1][2] == 0 and got[1][3] == 5


def test_ctc_loss_and_gradient_match_jax():
    """A row whose collapsed target is as long as its valid frames (the
    tightest feasible alignment), one with no valid frame label (an empty
    target), and ragged ones: the loss and its gradient with respect to
    the log-probs, in f32."""
    b, t = 4, 12
    lengths = np.array([12, 5, 9, 7], np.int32)
    labels = _labels(1, b, t, lengths)
    labels[1, :5] = [1, 4, 1, 4, 1]  # collapsed length 5 = valid length
    labels[3] = -1  # no valid frame: target length 0
    targets, tl = plosses.prepare_ctc_targets(labels.reshape(-1), b)
    assert tl[1] == lengths[1] and tl[3] == 0
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(b, t, N_CLASS + 1)).astype(np.float32)
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))

    def jf(a):
        return jlosses.ctc_loss(a, jnp.asarray(lengths), jnp.asarray(targets),
                                jnp.asarray(tl), N_CLASS)

    want, jgrad = jax.jit(jax.value_and_grad(jf))(jnp.asarray(lp))
    x = torch.from_numpy(np.array(lp)).requires_grad_()
    got = plosses.ctc_loss(x, torch.from_numpy(lengths),
                           torch.from_numpy(targets), torch.from_numpy(tl),
                           N_CLASS)
    got.backward()
    assert np.isfinite(got.item())
    assert abs(got.item() - float(want)) <= 1e-5 * max(1.0, abs(float(want)))
    valid = np.arange(t)[None, :] < lengths[:, None]
    g, w = x.grad.numpy(), np.asarray(jgrad)
    assert np.abs(g[valid] - w[valid]).max() <= 1e-5
    assert not g[~valid].any()


# ctcloss narrowed (2 layers, H=16) in both packages, to bound the JAX
# compile; the default width runs the same code (test_torch_train.py)
NARROW = dict(gru_layer=2, hidden_dim_1=32)


def _jax_model(name):
    if name == "simple_fc":
        return jbuild(name, N_CLASS)
    cfg = jgru.BiGRUConfig(n_class=N_CLASS + 1, **NARROW)
    return ModelDef(name, cfg, lambda rng: jgru.init(rng, cfg),
                    lambda p, x, l, **kw: jgru.apply(p, cfg, x, l, **kw),
                    "log_probs")


def _port_model(name, params):
    model = build_model(name, N_CLASS, cfg_overrides=(
        NARROW if name == "ctcloss" else None))
    model.load_state_dict(from_jax_params(name, jax.tree.map(np.asarray,
                                                             params)))
    return model


def _pair(name, seed=0):
    mdef = _jax_model(name)
    params = mdef.init(jax.random.PRNGKey(seed))
    return mdef, params, _port_model(name, params)


def _batch(seed, b=3, t=24):
    rng = np.random.default_rng(seed)
    lengths = np.array([t, t // 2 + 1, 1][:b], np.int32)
    x = rng.normal(size=(b, t, 400)).astype(np.float32)
    x[np.arange(t)[None, :] >= lengths[:, None]] = 0.0
    return x, lengths, _labels(seed, b, t, lengths).reshape(-1), None


@pytest.mark.parametrize("name", ["simple_fc", "ctcloss"])
def test_forward_with_carried_weights_matches_jax(name):
    """Eval form: simple_fc's raw logits on every frame, ctcloss's
    log-probs over n_class + 1 outputs (the blank last) on valid frames."""
    mdef, params, model = _pair(name, seed=1)
    x, lengths, _, _ = _batch(1)
    want = np.asarray(mdef.apply(params, jnp.asarray(x), jnp.asarray(lengths)))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(lengths)).numpy()
    assert got.shape == want.shape == (3, 24, N_CLASS + (name == "ctcloss"))
    valid = np.arange(24)[None, :] < lengths[:, None]
    err = np.abs(got - want)[valid if name == "ctcloss" else ...].max()
    assert err <= 1e-5 * max(1.0, np.abs(want).max())


def _step_seeds(name, rng_key):
    """The dropout seeds of one JAX Trainer step (loop.py:174; ctcloss as
    the BiGRU, models/gru.py:37, rnn.py:522); simple_fc has none."""
    if name == "simple_fc":
        return []
    _, sub = jax.random.split(rng_key)
    r_in, r_rnn = jax.random.split(sub, 2)
    seeds = [int(jhash.rng_seed_u32(r_in))]
    for _ in range(NARROW["gru_layer"] - 1):
        r_rnn, s = jax.random.split(r_rnn)
        seeds.append(int(jhash.rng_seed_u32(s)))
    return seeds


@pytest.mark.parametrize("name", ["simple_fc", "ctcloss"])
def test_trainer_step_matches_jax_trainer(name):
    """One step from the same parameters with the JAX step's seeds: the
    loss (simple_fc's NLL over raw logits, ctcloss's CTC against the
    collapsed labels) and the parameters after one Adam update."""
    jtr = JTrainer(_jax_model(name), N_CLASS, lr=LR, seed=0)
    jts = jtr.init_state()
    tr = Trainer(_port_model(name, jts.params), N_CLASS, lr=LR, seed=0,
                 device="cpu")
    ts = tr.init_state()
    batch = _batch(2)
    seeds = _step_seeds(name, jts.rng)
    want = float(jtr.train_step(jts, batch))
    got = tr.train_step(ts, batch, seeds=seeds).item()
    assert np.isfinite(got)
    assert abs(got - want) <= 1e-5 * max(1.0, abs(want))
    flat = {k: np.asarray(v) for k, v in jckpt._flatten(jts.params).items()}
    for k, p in ts.model.named_parameters():
        # an Adam step is LR-sized whatever the gradient: a near-zero
        # gradient element's sign may flip between two f32 sums
        diff = np.abs(p.detach().numpy() - flat[k.replace(".", "/")])
        assert int((diff > 1e-4).sum()) <= max(1, diff.size // 1000), k
        assert diff.max() <= 2.5 * LR, k


def test_simple_fc_test_csv_byte_identical_to_jax(synthetic_root, tmp_path,
                                                  monkeypatch):
    """A JAX-written simple_fc checkpoint (the inference CLIs build it with
    the class defaults) served by both CLIs: the same CSV bytes."""
    n_class = len(open(os.path.join(synthetic_root, "splits", "splits",
                                    "mapping_bf.txt")).read().split("\n")) - 1
    mdef = jbuild("simple_fc", n_class, defaults=True)
    models = tmp_path / "models"
    models.mkdir()
    jckpt.save_params(str(models / "simple_fc_00.00_dev.npz"),
                      mdef.init_params(jax.random.PRNGKey(5)))
    argv = ["--pretrained_model", "simple_fc_00.00_dev", "--prob", "big",
            "--part", "test", "--data_dir",
            os.path.join(str(synthetic_root), "data"), "--annot_path",
            str(synthetic_root), "--models_dir", str(models),
            "--results_dir", "res", "--bucket_multiple", "32"]
    out = {}
    for d, main, extra in (("jax", jcli.main, []),
                           ("port", pcli.main, ["--device", "cpu"])):
        (tmp_path / d).mkdir()
        monkeypatch.chdir(tmp_path / d)
        out[d] = (tmp_path / d / main(argv + extra)).read_bytes()
    assert out["port"].startswith(b"Id,Category\n")
    assert out["port"] == out["jax"]
