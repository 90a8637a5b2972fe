"""CPU: the int8 evaluator of both packages on the archived 20x128 net.

    python scripts/int8_accuracy_torch_vs_jax.py [positions]

The JAX package's ``models/quant.py`` and the PyTorch port's
``alphazero_torch/models/quant.py`` quantise the same archived weights
(``artifacts/model_r5_latest.npz``), calibrate static scales on the same
1,024 random-play positions (``chip_smoke.random_positions``, seeds 51
and 52, as ``chip_smoke.py`` phase 10 does) and run the bf16 int8 forward,
static and dynamic, on ``positions`` other random-play positions (seed
71). Each prints its policy TV mean, argmax agreement and value MAE
against its own float32 net: the basis of ``chip_smoke.INT8_VS_F32``.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np
import torch
from flax import traverse_util

import chip_smoke
from alphazero_torch.env import breakthrough as tenv
from alphazero_torch.models import quant as tquant
from alphazero_torch.models.convert import load_archive
from alphazero_torch.models.network import wl_to_value
from alphazero_tpu.models import quant as jquant
from alphazero_tpu.models.network import AlphaZeroNet


def report(pkg, flavor, p, pf, v, vf):
    tv = 0.5 * np.abs(p - pf).sum(-1)
    print(f"{pkg} int8 {flavor}: policy TV mean {tv.mean():.4f}, argmax "
          f"agreement {(p.argmax(-1) == pf.argmax(-1)).mean():.4f}, value "
          f"MAE {np.abs(v - vf).mean():.4f}", flush=True)


def main(n=256):
    planes = np.asarray(tenv.encoded_state(chip_smoke.random_positions(n, 71)))
    cal = [np.asarray(tenv.encoded_state(chip_smoke.random_positions(512, s)))
           for s in (51, 52)]

    flat = dict(np.load(chip_smoke.ARCHIVE))
    variables = {col: traverse_util.unflatten_dict({
        tuple(k.split("/")[1:]): jnp.asarray(v, jnp.float32)
        for k, v in flat.items() if k.startswith(col + "/")})
        for col in ("params", "batch_stats")}
    fnet = AlphaZeroNet(num_blocks=20, num_filters=128, se_ratio=8)
    pl, wl = fnet.apply(variables, jnp.asarray(planes), train=False)
    pf, vf = np.asarray(jax.nn.softmax(pl, -1)), np.asarray(
        jquant.wl_to_value(wl))
    qp = jquant.quantize_network(fnet, variables)
    act = jquant.calibrate(qp, [jnp.asarray(c) for c in cal])
    for flavor, sc in (("static", act), ("dynamic", None)):
        pl, wl = jquant.quant_apply(qp, jnp.asarray(planes), act_scales=sc)
        report("JAX", flavor, np.asarray(jax.nn.softmax(pl, -1)), pf,
               np.asarray(jquant.wl_to_value(wl)), vf)

    net = load_archive(chip_smoke.ARCHIVE, device="cpu")
    x = torch.from_numpy(planes)
    with torch.no_grad():
        pl, wl = net(x)
    pf, vf = torch.softmax(pl, -1).numpy(), wl_to_value(wl).numpy()
    qp = tquant.quantize_network(net)
    act = tquant.calibrate(qp, [torch.from_numpy(c) for c in cal])
    for flavor, sc in (("static", act), ("dynamic", None)):
        pl, wl = tquant.quant_apply(qp, x, act_scales=sc)
        report("port", flavor, torch.softmax(pl, -1).numpy(), pf,
               wl_to_value(wl).numpy(), vf)


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
