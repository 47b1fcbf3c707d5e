"""Weight bridge (voxactb_tpu_torch.weights): a flax parameter tree of the JAX
package fills the port's module strictly — every leaf consumed once, every
torch parameter set, every shape checked."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxactb_tpu.agents.qfunction import build_encoder as jax_build_encoder
from voxactb_tpu.config import MethodConfig as JaxMethodConfig
from voxactb_tpu_torch.agents.qfunction import build_encoder
from voxactb_tpu_torch.config import MethodConfig
from voxactb_tpu_torch.weights import flax_targets, load_flax_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one thread: at these sizes its intra-op pool only contends
    with itself and with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

TINY = dict(voxel_sizes=[10], num_latents=16, latent_dim=32, transformer_depth=1,
            latent_heads=2, latent_dim_head=16, cross_dim_head=16)


def _jax_tree(kw):
    cfg = JaxMethodConfig(**kw)
    model = jax_build_encoder(cfg)
    n, ld = cfg.voxel_size, cfg.proprio_width()
    params = model.init(jax.random.key(0), jnp.zeros((1, n, n, n, 10)),
                        jnp.zeros((1, ld)), jnp.zeros((1, 1024)),
                        jnp.zeros((1, 77, 512)))
    return jax.tree_util.tree_map(np.asarray, params)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.fixture(scope="module")
def dominant():
    kw = dict(TINY, which_arm="dominant", arm_pred_loss=True)
    return kw, _jax_tree(kw)


@pytest.mark.parametrize("variant", ["dominant_arm_pred", "two_heads"])
def test_every_leaf_consumed_and_every_param_set(dominant, variant):
    if variant == "two_heads":
        kw = dict(TINY, which_arm="both", variant="one_policy_more_heads")
        tree = _jax_tree(kw)
    else:
        kw, tree = dominant
    module = build_encoder(MethodConfig(**kw), device="cpu", seed=3)
    targets = flax_targets(module)
    leaves = dict(_flat(tree["params"]))
    assert set(targets) == set(leaves)
    load_flax_params(module, tree)
    # every torch parameter now holds its flax leaf (through its mapping)
    for path, entries in targets.items():
        for param, fn in entries:
            np.testing.assert_array_equal(param.detach().numpy(), fn(leaves[path]))


def test_layouts(dominant):
    kw, tree = dominant
    module = build_encoder(MethodConfig(**kw), device="cpu")
    load_flax_params(module, tree)
    p = tree["params"]
    # Dense [in, out] -> Linear [out, in]
    np.testing.assert_array_equal(module.lang_preprocess.weight.detach().numpy(),
                                  p["lang_preprocess"]["kernel"].T)
    # to_kv: k = first half of the output columns, v = second half
    kv = p["cross_attend"]["attn"]["to_kv"]["kernel"]
    inner = kv.shape[1] // 2
    attn = module.cross_attend.attn
    np.testing.assert_array_equal(attn.to_k.weight.detach().numpy(), kv[:, :inner].T)
    np.testing.assert_array_equal(attn.to_v.weight.detach().numpy(), kv[:, inner:].T)
    # conv DHWIO -> OIDHW, read back through kernel_dhwio()
    np.testing.assert_array_equal(module.final.kernel_dhwio().detach().numpy(),
                                  p["final"]["kernel"])
    # LayerNorm scale -> weight; whole-kept tensors
    np.testing.assert_array_equal(module.cross_ff.norm.weight.detach().numpy(),
                                  p["cross_ff"]["norm"]["scale"])
    np.testing.assert_array_equal(module.up0.out_kernel.detach().numpy(),
                                  p["up0"]["out_kernel"])
    np.testing.assert_array_equal(module.pos_encoding.detach().numpy(),
                                  p["pos_encoding"])


@pytest.mark.parametrize("mutation", ["missing", "extra", "shape"])
def test_mismatch_raises_and_writes_nothing(dominant, mutation):
    kw, tree = dominant
    tree = copy.deepcopy(tree)
    p = tree["params"]
    if mutation == "missing":
        del p["dense1"]["Dense_0"]["bias"]
    elif mutation == "extra":
        p["dense1"]["Dense_0"]["scale"] = np.ones((4,), np.float32)
    else:
        p["latents"] = np.zeros((3, 3), np.float32)
    module = build_encoder(MethodConfig(**kw), device="cpu")
    before = {k: v.clone() for k, v in module.state_dict().items()}
    with pytest.raises(ValueError):
        load_flax_params(module, tree)
    for k, v in module.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_torch_parameter_without_leaf_raises(dominant):
    kw, tree = dominant
    module = build_encoder(MethodConfig(**kw), device="cpu")
    module.extra = torch.nn.Parameter(torch.zeros(2))
    with pytest.raises(ValueError, match="extra"):
        load_flax_params(module, tree)


def test_seeded_init_is_deterministic_and_seed_dependent():
    cfg = MethodConfig(**TINY)
    a = build_encoder(cfg, device="cpu", seed=0).state_dict()
    b = build_encoder(cfg, device="cpu", seed=0).state_dict()
    c = build_encoder(cfg, device="cpu", seed=1).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["latents"], c["latents"])
