"""pytorch_video_action_tpu_torch — the PyTorch and CUDA port of
``pytorch_video_action_tpu`` for one NVIDIA H100.

Module paths mirror the JAX package so each part's counterpart is easy to
find.  The port imports ``torch`` and numpy, never ``jax`` and nothing of
the JAX package; it keeps its own copies of the host code it needs.  Every
Pallas kernel on a ported path becomes a hand-written CUDA kernel under
``csrc/``, built with ``nvcc`` at first use; on CPU tensors each kernel's
plain PyTorch version runs instead.

Ported so far, served (``python -m
pytorch_video_action_tpu_torch.cli.inference_cli``) and trained (``...
.cli.train_cli``) end to end: bigru, bilstm, attn; trained: bilstm_lm,
win_attn.
"""

N_FEAT = 400  # I3D feature dimension (reference data_utils.py:147 loadtxt width)
TARGET_PAD = -1  # padding label (reference train.py:12)
