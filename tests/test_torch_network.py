"""PyTorch port's SE-ResNet held against the JAX package's Flax net.

Weights travel through the archive key scheme (``params/<path>``,
``batch_stats/<path>``), built from a Flax tree with
``flax.traverse_util.flatten_dict``, so the converter never sees Flax.
Logits must agree within 1e-4 in float32 on the CPU (summation order
differs between XLA and PyTorch's CPU convolutions).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# tiny tensors: intra-op threads only add overhead beside xdist workers
torch.set_num_threads(1)
from flax import traverse_util

from alphazero_tpu.config import tiny_config as jax_tiny_config
from alphazero_tpu.models.network import AlphaZeroNet as FlaxNet
from alphazero_tpu.models.network import init_network
from alphazero_tpu.models.network import policy_value_apply as jax_pva

from alphazero_torch.config import tiny_config
from alphazero_torch.models import convert
from alphazero_torch.models.network import (
    AlphaZeroNet,
    build_network,
    count_params,
    policy_value_apply,
)
from alphazero_torch.search.mcts import make_net_evaluator

ARCHIVE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "artifacts", "model_r5_latest.npz")
TOL = 1e-4


def _flat(variables):
    flat = {}
    for col in ("params", "batch_stats"):
        for path, leaf in traverse_util.flatten_dict(variables[col]).items():
            flat[col + "/" + "/".join(path)] = np.asarray(leaf)
    return flat


def _planes(n, seed):
    x = np.random.default_rng(seed).random((n, 3, 8, 8)) > 0.5
    x = x.astype(np.float32)
    x[:, 2] = 1.0
    return x


@pytest.mark.parametrize("blocks,filters,seed", [(2, 32, 0), (1, 16, 1)])
def test_tiny_net_logits_match_flax(blocks, filters, seed):
    cfg = jax_tiny_config(num_blocks=blocks, num_filters=filters)
    net, variables = init_network(cfg, jax.random.PRNGKey(seed))
    # non-trivial BN statistics, so the running stats are exercised
    rng = np.random.default_rng(seed)
    variables = dict(variables)
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape), jnp.float32),
        variables["batch_stats"])
    tnet = AlphaZeroNet(blocks, filters, 8).eval()
    convert.load_flat_into(tnet, _flat(variables))
    x = _planes(16, seed)
    pj, wj = net.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        pt, wt = tnet(torch.from_numpy(x))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=TOL, rtol=0)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=TOL, rtol=0)
    probs, value = policy_value_apply(tnet, torch.from_numpy(x))
    jp, jv = jax_pva(net, variables, jnp.asarray(x))
    np.testing.assert_allclose(probs.numpy(), np.asarray(jp), atol=TOL)
    np.testing.assert_allclose(value.numpy(), np.asarray(jv), atol=TOL)


def test_archive_net_logits_match_flax():
    with np.load(ARCHIVE) as data:
        flat = {k: data[k] for k in data.files}
    cfg = convert.config_from_archive(ARCHIVE)
    assert (cfg.num_blocks, cfg.num_filters, cfg.se_ratio) == (20, 128, 8)
    fnet = FlaxNet(num_blocks=20, num_filters=128, se_ratio=8)
    variables = {}
    for col in ("params", "batch_stats"):
        sub = {tuple(k.split("/")[1:]): jnp.asarray(v, jnp.float32)
               for k, v in flat.items() if k.startswith(col + "/")}
        variables[col] = traverse_util.unflatten_dict(sub)
    tnet = convert.load_archive(ARCHIVE, device="cpu")
    assert count_params(tnet) == 8_027_970
    x = _planes(4, 7)
    pj, wj = fnet.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        pt, wt = tnet(torch.from_numpy(x))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=TOL, rtol=0)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=TOL, rtol=0)


def test_flagship_param_count_and_flatten_order_matters():
    assert count_params(AlphaZeroNet(20, 128, 8)) == 8_027_970
    # a policy_fc kernel loaded WITHOUT the (h,w,c)->(c,h,w) permutation
    # must change the logits: the permutation is not a no-op
    cfg = jax_tiny_config(num_blocks=1, num_filters=8)
    net, variables = init_network(cfg, jax.random.PRNGKey(3))
    flat = _flat(variables)
    good = convert.load_flat_into(AlphaZeroNet(1, 8, 8).eval(), flat)
    bad = AlphaZeroNet(1, 8, 8).eval()
    bad.load_state_dict(good.state_dict())
    with torch.no_grad():
        bad.policy_fc.weight.copy_(torch.from_numpy(
            flat["params/policy_fc/kernel"].T.copy()))
        x = torch.from_numpy(_planes(4, 3))
        assert not torch.allclose(good(x)[0], bad(x)[0], atol=1e-3)


def test_converter_rejects_mismatched_archive():
    cfg = jax_tiny_config(num_blocks=1, num_filters=8)
    _, variables = init_network(cfg, jax.random.PRNGKey(0))
    flat = _flat(variables)
    with pytest.raises(ValueError, match="missing"):
        convert.load_flat_into(AlphaZeroNet(2, 8, 8), flat)
    with pytest.raises(ValueError, match="shape"):
        convert.load_flat_into(AlphaZeroNet(1, 16, 8), flat)


def test_bf16_evaluator_close_to_f32_and_generator_init():
    cfg = tiny_config()
    a = build_network(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(5))
    b = build_network(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(5))
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    x = torch.from_numpy(_planes(8, 2))
    p32, v32 = make_net_evaluator(a)(x)
    p16, v16 = make_net_evaluator(a, torch.bfloat16)(x)
    assert p16.dtype == torch.float32 and v16.dtype == torch.float32
    # the float32 net is untouched by building the bf16 evaluator
    assert next(a.parameters()).dtype == torch.float32
    torch.testing.assert_close(p16, p32, atol=0.02, rtol=0)
    torch.testing.assert_close(v16, v32, atol=0.02, rtol=0)


def test_bf16_limits_cover_jax_bf16_inference():
    """chip_smoke.py holds the port's bf16 forward of the archive net to
    limits on the logits, probabilities and value (against f32). The JAX
    package's own bf16 inference of the same net, on the same 64
    positions, must stay within half of each limit, and the port's bf16
    forward on the CPU within each limit."""
    import chip_smoke
    from alphazero_torch.env import breakthrough as tenv

    with np.load(ARCHIVE) as data:
        flat = {k: data[k] for k in data.files}
    variables = {}
    for col in ("params", "batch_stats"):
        sub = {tuple(k.split("/")[1:]): jnp.asarray(v, jnp.float32)
               for k, v in flat.items() if k.startswith(col + "/")}
        variables[col] = traverse_util.unflatten_dict(sub)
    planes = tenv.encoded_state(chip_smoke.random_positions(64, 11))
    x = jnp.asarray(planes.numpy())
    p32, w32 = (np.asarray(a) for a in
                FlaxNet(20, 128, 8).apply(variables, x))
    p16, w16 = (np.asarray(a) for a in
                FlaxNet(20, 128, 8, dtype=jnp.bfloat16).apply(variables, x))
    tnet = convert.load_archive(ARCHIVE, device="cpu").to(torch.bfloat16)
    with torch.no_grad():
        tp, tw = (a.numpy() for a in tnet(planes.bfloat16()))

    def softmax(a):
        e = np.exp(a - a.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)

    def deviation(p, w):
        value = lambda v: softmax(v)[:, 0] - softmax(v)[:, 1]
        return (max(np.abs(p - p32).max(), np.abs(w - w32).max()),
                np.abs(softmax(p) - softmax(p32)).max(),
                np.abs(value(w) - value(w32)).max())

    limits = chip_smoke.BF16_LIMITS
    for dev, lim in zip(deviation(p16, w16), limits):
        assert dev <= lim / 2
    for dev, lim in zip(deviation(tp, tw), limits):
        assert dev <= lim
