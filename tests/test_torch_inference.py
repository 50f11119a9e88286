"""The port's inference path (``pytorch_video_action_tpu_torch/cli/
inference_cli.py`` and what it calls) against the JAX package's, on the
``synthetic_root`` dataset, with one seeded bigru checkpoint written by the
JAX ``save_params``.  The port runs on the CPU (``--device cpu``), where the
GRU layer is its plain PyTorch version."""

import os

import numpy as np
import pytest
import torch

import jax

from pytorch_video_action_tpu.cli import inference_cli as jcli
from pytorch_video_action_tpu.data import VideoDataset as JVideoDataset
from pytorch_video_action_tpu.data.collate import bucket_length as jbucket
from pytorch_video_action_tpu.infer import loader as jloader
from pytorch_video_action_tpu.infer import predict as jpredict
from pytorch_video_action_tpu.infer import voting as jvoting
from pytorch_video_action_tpu.models import build_model as jbuild
from pytorch_video_action_tpu.train import save_params as jsave
from pytorch_video_action_tpu.utils import csvout as jcsv
from pytorch_video_action_tpu.utils import runlength as jrl
from pytorch_video_action_tpu_torch.cli import inference_cli as pcli
from pytorch_video_action_tpu_torch.data.collate import bucket_length
from pytorch_video_action_tpu_torch.data.dataset import VideoDataset
from pytorch_video_action_tpu_torch.infer import loader as ploader
from pytorch_video_action_tpu_torch.infer import voting as pvoting
from pytorch_video_action_tpu_torch.infer.predict import frame_predictions
from pytorch_video_action_tpu_torch.utils import csvout as pcsv
from pytorch_video_action_tpu_torch.utils import runlength as prl

NAME = "bigru_00.00_dev"


@pytest.fixture(scope="module")
def models_dir(synthetic_root, tmp_path_factory):
    """A full-width bigru checkpoint from seeded weights, JAX-written."""
    d = tmp_path_factory.mktemp("torch_infer_models")
    n_class = len(open(os.path.join(synthetic_root, "splits", "splits",
                                    "mapping_bf.txt")).read().split("\n")) - 1
    mdef = jbuild("bigru", n_class, defaults=True)
    jsave(os.path.join(d, f"{NAME}.npz"), mdef.init_params(jax.random.PRNGKey(0)))
    return str(d)


def _argv(root, models_dir, results_dir, part, *extra):
    return ["--pretrained_model", NAME, "--prob", "big", "--part", part,
            "--data_dir", os.path.join(str(root), "data"),
            "--annot_path", str(root), "--models_dir", models_dir,
            "--results_dir", str(results_dir), "--bucket_multiple", "32",
            *extra]


def test_test_csv_byte_identical_to_jax(synthetic_root, models_dir, tmp_path,
                                        monkeypatch):
    # each CLI in its own directory, so each parses the gz features itself
    for d in ("jax", "port"):
        (tmp_path / d).mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    want = jcli.main(_argv(synthetic_root, models_dir, "res", "test"))
    want_bytes = (tmp_path / "jax" / want).read_bytes()
    monkeypatch.chdir(tmp_path / "port")
    got = pcli.main(_argv(synthetic_root, models_dir, "res", "test",
                          "--device", "cpu"))
    got_bytes = (tmp_path / "port" / got).read_bytes()
    assert got_bytes.startswith(b"Id,Category\n")
    assert not got_bytes.endswith(b"\n")
    assert got_bytes == want_bytes


def test_dev_accuracy_equals_jax_and_reads_its_cache(synthetic_root, models_dir,
                                                     tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    want = jcli.main(_argv(synthetic_root, models_dir, "res", "dev"))
    assert os.path.exists(os.path.join("data-comp", "dev-0-features.npy"))
    # the port finds the JAX-written data-comp cache under the same names
    got = pcli.main(_argv(synthetic_root, models_dir, "res", "dev",
                          "--device", "cpu"))
    assert got == want


def test_frame_predictions_match_jax(synthetic_root, models_dir, monkeypatch,
                                     tmp_path):
    monkeypatch.chdir(tmp_path)
    kw = dict(data_dir=os.path.join(str(synthetic_root), "data"),
              annot_path=str(synthetic_root), part="dev", split=0,
              mode="active")
    jds = JVideoDataset(load_all=True, verbose=False, **kw)
    pds = VideoDataset(verbose=False, **kw)
    for a, b in zip(jds.features, pds.features):
        np.testing.assert_array_equal(a, b)
    mdef, params = jloader.load_models([NAME], jds.n_class,
                                       models_dir=models_dir)[NAME]
    want = jpredict.frame_predictions(mdef, params, jds.features,
                                      bucket_multiple=32, batch_size=3)
    model = ploader.load_models([NAME], pds.n_class, models_dir=models_dir)[NAME]
    got = frame_predictions(model, pds.features, bucket_multiple=32,
                            batch_size=3)
    for (gp, gm), (wp, wm) in zip(got, want):
        assert gp.dtype == np.int64 and gp.shape == wp.shape
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_allclose(gm, wm, atol=1e-4, rtol=0)


def test_parity_quirks_csv_is_complete_and_repeatable(synthetic_root,
                                                      models_dir, tmp_path,
                                                      monkeypatch):
    # dropout at test time draws the port's own seeds: not compared with JAX
    monkeypatch.chdir(tmp_path)
    argv = _argv(synthetic_root, models_dir, "res", "test", "--device", "cpu",
                 "--parity_quirks")
    first = open(pcli.main(argv)).read()
    second = open(pcli.main(argv + ["--results_dir", "res2"])).read()
    n_seg = sum(len(line.split()) - 1 for line in
                open(os.path.join(synthetic_root, "segment.txt")) if line.strip())
    assert first == second
    assert len(first.split("\n")) == 1 + n_seg


def test_device_cuda_raises_without_card(synthetic_root, models_dir, tmp_path,
                                         monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pcli.main(_argv(synthetic_root, models_dir, "res", "test"))


def test_data_parallel_is_not_ported(synthetic_root, models_dir, tmp_path,
                                     monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match="item 15"):
        pcli.main(_argv(synthetic_root, models_dir, "res", "test",
                        "--device", "cpu", "--data_parallel", "2"))


def test_unported_family_checkpoint_raises(tmp_path):
    with pytest.raises(NotImplementedError, match="item 11"):
        ploader.load_models(["mstcn_75.59_dev"], 48, models_dir=str(tmp_path))


@pytest.mark.parametrize("name", ["bigru_73.52_dev", "vanilla_lstm_70.11_dev",
                                  "mstcn_75.59_dev", "simple_fc_1.00_dev.npz"])
def test_parse_model_type_matches_jax(name):
    assert ploader.parse_model_type(name) == jloader.parse_model_type(name)


@pytest.mark.parametrize("seed", range(4))
def test_voting_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        n = int(rng.integers(1, 30))
        seg = rng.integers(0, int(rng.integers(1, 6)), n)
        for quirk in (False, True):
            assert (pvoting.zero_avoided_vote(seg, quirk)
                    == jvoting.zero_avoided_vote(seg, quirk))
        maxp = -rng.random(n).astype(np.float32)
        s, e = sorted(int(v) for v in rng.integers(0, n + 1, 2))
        e = max(e, s + 1) if s < n else n
        if s < e:
            assert (pvoting.model_segment_result(seg, maxp, s, e, float(maxp.sum()))
                    == jvoting.model_segment_result(seg, maxp, s, e,
                                                    float(maxp.sum())))
        k = int(rng.integers(0, 5))
        labels = rng.integers(1, 4, k).tolist()
        probs = rng.random(k).tolist()
        frames = rng.integers(1, 3, k).tolist()
        for pref in ("big", "small"):
            assert (pvoting.select_across_models(labels, probs, frames, pref)
                    == jvoting.select_across_models(labels, probs, frames, pref))


@pytest.mark.parametrize("results", [[], [3], [1, 0, 47, 5]])
def test_submission_bytes_match_jax(results, tmp_path):
    pcsv.write_submission(str(tmp_path / "p"), results)
    jcsv.write_submission(str(tmp_path / "j"), results)
    assert (tmp_path / "p").read_bytes() == (tmp_path / "j").read_bytes()


def test_run_length_and_buckets_match_jax():
    rng = np.random.default_rng(0)
    for n in (0, 1, 7, 40):
        labels = rng.integers(0, 3, n).tolist()
        assert prl.run_length_segments(labels) == jrl.run_length_segments(labels)
    for length in (1, 31, 32, 33, 500, 2500):
        for mult in (0, 1, 32, 128):
            assert bucket_length(length, mult) == jbucket(length, mult)
