"""Weight import from the JAX package's archive key scheme.

An archive (``scripts/archive_model.py``) is a flat npz of
``params/<path>`` (float16) and ``batch_stats/<path>`` (float32) arrays,
with ``<path>`` the Flax module path joined by ``/``, plus ``__meta__``
(JSON bytes holding ``arch``). ``state_dict_from_flat`` turns such a flat
dict into this port's ``state_dict``:

- conv kernels HWIO -> OIHW; dense kernels (in, out) -> (out, in);
- Flax flattens NHWC, as (h, w, c), before ``policy_fc`` and
  ``value_fc1``; this port flattens NCHW, so those two weight matrices
  are permuted to (c, h, w) input order. Without the permutation the net
  loads without error and computes garbage;
- BN: scale -> weight, bias -> bias, mean/var -> running_mean/var (both
  frameworks use eps 1e-5);
- every array is upcast to float32;
- a scan-stacked archive (``scan_blocks=True``: ``tower/block/<leaf>``
  with the blocks on a leading axis) is unstacked into ``blocks.<i>``.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch

from alphazero_torch import resolve_device
from alphazero_torch.config import Config
from alphazero_torch.models.network import AlphaZeroNet

# the trained 20x128 archive in the repo, the default weights of the bench
# and the strength gates
ARCHIVE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "artifacts", "model_r5_latest.npz")

# dense layers whose input is a flattened (h, w, c) map in the JAX net
_FLATTENED_INPUT = ("policy_fc", "value_fc1")


def _torch_module_path(flax_path: str) -> str:
    """'block_3/se/fc1' -> 'blocks.3.se.fc1'."""
    parts = flax_path.split("/")
    if parts[0].startswith("block_"):
        parts = ["blocks", parts[0][len("block_"):]] + parts[1:]
    return ".".join(parts)


def _convert_kernel(module: str, kernel: np.ndarray) -> np.ndarray:
    if kernel.ndim == 4:                                  # HWIO -> OIHW
        return kernel.transpose(3, 2, 0, 1)
    if module in _FLATTENED_INPUT:
        # rows indexed (h*W + w)*C + c -> columns indexed c*H*W + h*W + w
        n_in, n_out = kernel.shape
        hw = 64
        return kernel.reshape(hw, n_in // hw, n_out).transpose(2, 1, 0) \
                     .reshape(n_out, n_in)
    return kernel.T                                       # (in,out)->(out,in)


def _unstacked(flat: Dict[str, np.ndarray]):
    """(key, array) pairs of ``flat`` with every scan-stacked leaf
    ``<col>/tower/block/<leaf path>`` (leading axis = block) split into
    ``<col>/block_<i>/<leaf path>``."""
    for key, value in flat.items():
        collection, _, path = key.partition("/")
        if path.startswith("tower/block/"):
            rest = path[len("tower/block/"):]
            for i, leaf in enumerate(np.asarray(value)):
                yield f"{collection}/block_{i}/{rest}", leaf
        else:
            yield key, value


_LEAF_NAMES = {
    ("params", "kernel"): "weight",
    ("params", "bias"): "bias",
    ("params", "scale"): "weight",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def state_dict_from_flat(flat: Dict[str, np.ndarray]
                         ) -> Dict[str, torch.Tensor]:
    """Archive-scheme flat dict -> ``AlphaZeroNet`` state_dict entries
    (float32, CPU). Keys other than ``params/...`` and ``batch_stats/...``
    are ignored; BN ``num_batches_tracked`` counters are not produced."""
    out = {}
    for key, value in _unstacked(flat):
        collection, _, path = key.partition("/")
        if collection not in ("params", "batch_stats"):
            continue
        module_path, _, leaf = path.rpartition("/")
        name = _LEAF_NAMES.get((collection, leaf))
        if name is None:
            raise ValueError(f"unexpected archive key {key!r}")
        arr = np.asarray(value, np.float32)
        module = _torch_module_path(module_path)
        if leaf == "kernel":
            arr = _convert_kernel(module, arr)
        out[f"{module}.{name}"] = torch.tensor(arr)
    return out


def load_flat_into(net: AlphaZeroNet, flat: Dict[str, np.ndarray]
                   ) -> AlphaZeroNet:
    """Load an archive-scheme flat dict into ``net`` (every parameter and
    BN statistic must be present, with matching shapes). The JAX
    package's archives hold SE-ResNets: any other net raises."""
    if not isinstance(net, AlphaZeroNet):
        raise ValueError(f"a JAX archive holds an SE-ResNet, not a "
                         f"{type(net).__name__}")
    sd = state_dict_from_flat(flat)
    own = net.state_dict()
    missing = [k for k in own
               if k not in sd and not k.endswith("num_batches_tracked")]
    extra = [k for k in sd if k not in own]
    if missing or extra:
        raise ValueError(f"archive mismatch: missing {missing[:5]}, "
                         f"unexpected {extra[:5]}")
    for k, v in sd.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"{k}: archive shape {tuple(v.shape)} != "
                             f"net shape {tuple(own[k].shape)}")
        own[k] = v
    net.load_state_dict(own)
    return net


def config_from_archive(path: str) -> Config:
    """The archive's architecture as a ``Config`` (other fields default)."""
    with np.load(path) as data:
        arch = json.loads(bytes(data["__meta__"]))["arch"]
    return Config(num_blocks=arch["num_blocks"],
                  num_filters=arch["num_filters"],
                  se_ratio=arch.get("se_ratio", 8))


def quant_params_from_numpy(tree, device="cuda"):
    """The JAX package's QuantParams (``alphazero_tpu.models.quant.
    quantize_network``'s output with every leaf a numpy array: ``qk`` HWIO
    int8, per-channel ``scale`` and ``bias``, the folded policy and value
    convs as (HWIO kernel, bias), SE and FC params as {"kernel" (in, out),
    "bias"}) -> the port's (``alphazero_torch.models.quant``): the same
    structure as torch tensors on ``device``, each s8 conv with its weights
    in the kernel's layout added. The dense kernels keep their (h, w, c)
    input order: the port's int8 forward flattens NHWC as the JAX one
    does. So both packages run on the same int8 weights."""
    from alphazero_torch.models.quant import qconv_entry

    dev = resolve_device(device)

    def leaves(t):
        if isinstance(t, dict):
            return {k: leaves(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(leaves(v) for v in t)
        return torch.from_numpy(np.array(t)).to(dev)

    qp = leaves(tree)
    qp["input"] = qconv_entry(**qp["input"])
    for b in qp["blocks"]:
        b["conv1"] = qconv_entry(**b["conv1"])
        b["conv2"] = qconv_entry(**b["conv2"])
    return qp


def load_archive(path: str, device="cuda") -> AlphaZeroNet:
    """The archived net (float32, eval mode) on ``device``."""
    dev = resolve_device(device)
    cfg = config_from_archive(path)
    net = AlphaZeroNet(cfg.num_blocks, cfg.num_filters, cfg.se_ratio,
                       cfg.num_actions, cfg.input_planes, cfg.board_size)
    with np.load(path) as data:
        load_flat_into(net, {k: data[k] for k in data.files})
    return net.to(dev).eval()
