"""Model registry and factory (counterpart of
``pytorch_video_action_tpu/models/__init__.py``).

Every family of the JAX package is ported: ``simple_fc``,
``vanilla_lstm``, ``bilstm``, ``bilstm_lm``, ``attn``, ``win_attn``,
``bigru``, ``ms_tcn`` (also ``mstcn``, the inference CLIs' name) and
``ctcloss`` (the BiGRU with ``n_class + 1`` outputs, blank = ``n_class``).
Any other name raises ``NotImplementedError``.  A model names its family
(``model.name``, which picks its loss) and says whether it is stateful
(``model.stateful``: its module buffers are the JAX package's
``model_state``).
"""

from __future__ import annotations

import dataclasses

import torch

from .attention import Attn, AttnConfig, WinAttn, WinAttnConfig
from .gru import BiGRU, BiGRUConfig
from .lstm import (BiLSTM, BiLSTMConfig, BiLSTMWithLM, BiLSTMWithLMConfig,
                   VanillaLSTM, VanillaLSTMConfig)
from .mstcn import MSTCN, MSTCNConfig
from .simple_fc import SimpleFC, SimpleFCConfig

# names accepted by the inference drivers' checkpoint-filename parsing
# (inference.py:82-94; note 'mstcn' there vs 'ms_tcn' in train.py)
INFERENCE_NAMES = ["simple_fc", "vanilla_lstm", "bilstm", "bigru", "attn", "mstcn"]


def not_ported(name: str) -> Exception:
    return NotImplementedError(f"unknown model: {name}")


def build_model(name: str, n_class: int, *, pred_mode: str = "cont",
                lstm_layer: int = 2, lstm_dropout: float = 0.5,
                lstm_hidden1: int = 256, lstm_hidden2: int = 64,
                attn_head: int = 4, use_pallas: bool = False,
                defaults: bool = False, cfg_overrides: dict | None = None,
                generator: torch.Generator | None = None) -> torch.nn.Module:
    """Build a model.  ``defaults=True`` gives the inference CLIs'
    class-default hyperparameters (``inference.py:83-94``), the checkpoint
    contract; otherwise the train CLI's flags apply (``train.py:218-259``),
    as in the JAX package: simple_fc, bigru and ctcloss take none of them,
    vanilla_lstm ``lstm_layer``, ``lstm_dropout``, ``lstm_hidden1`` (its
    width) and ``pred_mode``, bilstm_lm all but ``pred_mode`` and ignores
    ``defaults``, attn takes ``attn_head`` and ``pred_mode``, win_attn
    ``attn_head`` alone, also with ``defaults``; ms_tcn (``mstcn``) takes
    ``use_pallas`` (its per-video dropout stream).  ``cfg_overrides``
    replaces fields of the model's config dataclass, the JAX package's
    parity-test hook (``models/__init__.py:62-73``; e.g. win_attn's
    ``mask_padding=False``); the JAX package applies it to win_attn's
    config alone, the port to every model's.  ``generator`` seeds the
    initial weights."""
    if name == "simple_fc":
        cls, cfg = SimpleFC, SimpleFCConfig(n_class=n_class)
    elif name in ("bigru", "ctcloss"):
        # ctcloss: one more output, the CTC blank (= n_class)
        cls, cfg = BiGRU, BiGRUConfig(
            n_class=n_class + (name == "ctcloss"))
    elif name == "vanilla_lstm":
        cls, cfg = VanillaLSTM, (
            VanillaLSTMConfig(n_class=n_class) if defaults
            else VanillaLSTMConfig(
                lstm_layer=lstm_layer, hidden_dim=lstm_hidden1,
                dropout_rate=lstm_dropout, n_class=n_class, mode=pred_mode))
    elif name == "bilstm":
        cls, cfg = BiLSTM, (
            BiLSTMConfig(n_class=n_class) if defaults else BiLSTMConfig(
                lstm_layer=lstm_layer, hidden_dim_1=lstm_hidden1,
                dropout_rate=lstm_dropout, hidden_dim_2=lstm_hidden2,
                n_class=n_class, mode=pred_mode))
    elif name == "bilstm_lm":
        cls, cfg = BiLSTMWithLM, BiLSTMWithLMConfig(
            lstm_layer=lstm_layer, hidden_dim_1=lstm_hidden1,
            dropout_rate=lstm_dropout, hidden_dim_2=lstm_hidden2,
            n_class=n_class)
    elif name == "attn":
        cls, cfg = Attn, (
            AttnConfig(n_class=n_class) if defaults else AttnConfig(
                num_heads=attn_head, n_class=n_class, mode=pred_mode))
    elif name == "win_attn":
        cls, cfg = WinAttn, WinAttnConfig(num_heads=attn_head,
                                          n_class=n_class)
    elif name in ("ms_tcn", "mstcn"):
        cls, cfg = MSTCN, MSTCNConfig(n_class=n_class, use_pallas=use_pallas)
    else:
        raise not_ported(name)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    model = cls(cfg, generator=generator)
    if name == "ctcloss":
        model.name = name  # picks the CTC loss
    return model
