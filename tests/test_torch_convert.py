"""The JAX -> port weight converter (roma_tpu_torch.models.convert): full
coverage with no leftovers at the tiny config, exact values, the failure
modes, and a shape-only coverage check at the released widths."""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from roma_tpu.models.config import RoMaConfig as JaxConfig
from roma_tpu.models.matcher import RoMaNet as JaxNet
from roma_tpu_torch.models.config import RoMaConfig
from roma_tpu_torch.models.convert import check_jax_shapes, from_jax_variables
from roma_tpu_torch.models.matcher import RoMaNet
from torch_port_fixtures import TINY, port_net, seeded_tiny_variables


@pytest.fixture(scope="module")
def variables():
    return seeded_tiny_variables(0)


def test_tiny_values_land_where_expected(variables):
    sd = port_net(variables).state_dict()
    p, s = variables["params"], variables["batch_stats"]
    vgg = p["encoder"]["vgg"]
    np.testing.assert_array_equal(
        sd["encoder.cnn.layers.3.weight"].numpy(), vgg["conv3"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["encoder.cnn.layers.37.running_var"].numpy(), s["encoder"]["vgg"]["bn37"]["var"])
    blk = p["encoder"]["dinov2"]["blocks"]["block"]
    np.testing.assert_array_equal(
        sd["encoder.dinov2.blocks.1.attn.qkv.weight"].numpy(), blk["attn"]["qkv"]["kernel"][1].T)
    np.testing.assert_array_equal(sd["encoder.dinov2.blocks.0.ls2.gamma"].numpy(), blk["ls2"]["gamma"][0])
    ref = p["decoder"]["refiner1"]
    np.testing.assert_array_equal(  # depthwise (K, K, 1, C) -> (C, 1, K, K)
        sd["decoder.conv_refiner.1.hidden_blocks.1.0.weight"].numpy(),
        ref["hidden"]["block"]["conv1"]["kernel"][1].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["decoder.conv_refiner.1.hidden_blocks.0.1.running_mean"].numpy(),
        s["decoder"]["refiner1"]["hidden"]["block"]["bn"]["mean"][0])
    np.testing.assert_array_equal(
        sd["decoder.gps.16.pos_conv.weight"].numpy(),
        p["decoder"]["gp16"]["pos_conv"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["decoder.proj.8.1.weight"].numpy(), p["decoder"]["proj8_bn"]["scale"])


def test_leftover_missing_and_misshaped_leaves_raise(variables):
    extra = copy.deepcopy(variables)
    extra["params"]["decoder"]["stray"] = {"kernel": np.zeros((1, 1, 2, 2), np.float32)}
    with pytest.raises(KeyError, match="stray"):
        from_jax_variables(extra, RoMaNet(TINY))
    missing = copy.deepcopy(variables)
    del missing["batch_stats"]["decoder"]["proj4_bn"]
    with pytest.raises(KeyError, match="no JAX leaf"):
        from_jax_variables(missing, RoMaNet(TINY))
    bad = copy.deepcopy(variables)
    bad["params"]["decoder"]["gp16"]["pos_conv"]["bias"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="pos_conv"):
        from_jax_variables(bad, RoMaNet(TINY))


def test_released_width_coverage_shapes_only():
    dummy = jnp.zeros((1, 56, 56, 3), jnp.float32)
    shapes = jax.eval_shape(JaxNet(config=JaxConfig()).init, jax.random.PRNGKey(0), dummy, dummy)
    with torch.device("meta"):
        net = RoMaNet(RoMaConfig())
    n = check_jax_shapes(shapes, net)
    n_port = sum(1 for k in net.state_dict() if not k.endswith("num_batches_tracked"))
    assert n == n_port
    assert sum(t.numel() for t in net.parameters()) > 300_000_000  # ViT-L + decoder
