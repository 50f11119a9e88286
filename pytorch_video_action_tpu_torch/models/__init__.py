"""Model registry and factory (counterpart of
``pytorch_video_action_tpu/models/__init__.py``).

Ported: ``bigru``, ``vanilla_lstm``, ``bilstm``, ``bilstm_lm``, ``attn``,
``win_attn`` and ``ms_tcn`` (also ``mstcn``, the inference CLIs' name).  Every other name of
the JAX package raises ``NotImplementedError`` naming the ROADMAP item
that ports it.  A model names its family (``model.name``, which picks its
loss) and says whether it is stateful (``model.stateful``: its module
buffers are the JAX package's ``model_state``).
"""

from __future__ import annotations

import torch

from .attention import Attn, AttnConfig, WinAttn, WinAttnConfig
from .gru import BiGRU, BiGRUConfig
from .lstm import (BiLSTM, BiLSTMConfig, BiLSTMWithLM, BiLSTMWithLMConfig,
                   VanillaLSTM, VanillaLSTMConfig)
from .mstcn import MSTCN, MSTCNConfig

# names accepted by the inference drivers' checkpoint-filename parsing
# (inference.py:82-94; note 'mstcn' there vs 'ms_tcn' in train.py)
INFERENCE_NAMES = ["simple_fc", "vanilla_lstm", "bilstm", "bigru", "attn", "mstcn"]

_ROADMAP_ITEM = {"simple_fc": 12, "ctcloss": 12}


def not_ported(name: str) -> Exception:
    item = _ROADMAP_ITEM.get(name)
    if item is None:
        return NotImplementedError(f"unknown model: {name}")
    return NotImplementedError(
        f"model {name!r} is not ported to PyTorch yet (ROADMAP.md, "
        f"'Modules to port', item {item})")


def build_model(name: str, n_class: int, *, pred_mode: str = "cont",
                lstm_layer: int = 2, lstm_dropout: float = 0.5,
                lstm_hidden1: int = 256, lstm_hidden2: int = 64,
                attn_head: int = 4, defaults: bool = False,
                generator: torch.Generator | None = None) -> torch.nn.Module:
    """Build a model.  ``defaults=True`` gives the inference CLIs'
    class-default hyperparameters (``inference.py:83-94``), the checkpoint
    contract; otherwise the train CLI's flags apply (``train.py:218-259``),
    as in the JAX package: bigru takes none of them, vanilla_lstm
    ``lstm_layer``, ``lstm_dropout``, ``lstm_hidden1`` (its width) and
    ``pred_mode``, bilstm_lm all but ``pred_mode`` and ignores
    ``defaults``, attn takes ``attn_head`` and
    ``pred_mode``, win_attn ``attn_head`` alone, also with ``defaults``;
    ms_tcn (``mstcn``) takes none.  ``generator`` seeds the initial
    weights."""
    if name == "bigru":
        return BiGRU(BiGRUConfig(n_class=n_class), generator=generator)
    if name == "vanilla_lstm":
        cfg = (VanillaLSTMConfig(n_class=n_class) if defaults
               else VanillaLSTMConfig(
                   lstm_layer=lstm_layer, hidden_dim=lstm_hidden1,
                   dropout_rate=lstm_dropout, n_class=n_class,
                   mode=pred_mode))
        return VanillaLSTM(cfg, generator=generator)
    if name == "bilstm":
        cfg = (BiLSTMConfig(n_class=n_class) if defaults else BiLSTMConfig(
            lstm_layer=lstm_layer, hidden_dim_1=lstm_hidden1,
            dropout_rate=lstm_dropout, hidden_dim_2=lstm_hidden2,
            n_class=n_class, mode=pred_mode))
        return BiLSTM(cfg, generator=generator)
    if name == "bilstm_lm":
        return BiLSTMWithLM(BiLSTMWithLMConfig(
            lstm_layer=lstm_layer, hidden_dim_1=lstm_hidden1,
            dropout_rate=lstm_dropout, hidden_dim_2=lstm_hidden2,
            n_class=n_class), generator=generator)
    if name == "attn":
        cfg = (AttnConfig(n_class=n_class) if defaults else AttnConfig(
            num_heads=attn_head, n_class=n_class, mode=pred_mode))
        return Attn(cfg, generator=generator)
    if name == "win_attn":
        return WinAttn(WinAttnConfig(num_heads=attn_head, n_class=n_class),
                       generator=generator)
    if name in ("ms_tcn", "mstcn"):
        return MSTCN(MSTCNConfig(n_class=n_class), generator=generator)
    raise not_ported(name)
