"""The port's registry against the JAX package's, arch by arch.

For each Uformer the port builds (`uformer_tpu_torch.models.registry`):
the JAX model of `uformer_tpu.get_arch` and the port's agree on every
hyperparameter, the JAX param tree (from eval_shape) carries into the
port's state_dict with `load_state_dict(strict=True)`, and at one block
per stage (the registry's depths cut to 1, the one override these archs
allow through `clone`) the two forwards agree at 128^2, batch 1, on
seeded weights (fp32, 1e-4 (1 + max|ref|)). The geometries below window 8
and at head dim 8 are among them: Uformer_B at train_ps 64 (its
bottleneck at window 4) and 32 (enc3 and dec0 at window 4, the bottleneck
at 2), Uformer at embed 8 (head dim 8 throughout) and at win_size 4.
"""

import numpy as np
import pytest
import torch

from uformer_tpu_torch.convert import state_dict_from_jax
from uformer_tpu_torch.models import Uformer
from uformer_tpu_torch.models.registry import arch_config

torch.set_num_threads(1)
SHALLOW = (1,) * 9

OPTS = [{"arch": "Uformer", "embed_dim": 16},
        {"arch": "Uformer", "embed_dim": 32},
        {"arch": "Uformer_S"}, {"arch": "Uformer_S_noshift"},
        {"arch": "Uformer_B_fastleff"},
        {"arch": "Uformer_B", "train_ps": 64},
        {"arch": "Uformer_B", "train_ps": 32},
        {"arch": "Uformer", "embed_dim": 8},
        {"arch": "Uformer", "embed_dim": 32, "win_size": 4}]


def _seeded(jax, tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: (0.05 * rng.standard_normal(a.shape)
                         + (jax.tree_util.keystr(path).endswith("['scale']")))
        .astype(np.float32), tree)


@pytest.mark.parametrize("opt", OPTS, ids=lambda o: "-".join(
    str(v) for v in o.values()))
def test_arch_matches_jax(opt):
    import jax
    import jax.numpy as jnp
    from uformer_tpu import get_arch as jax_get_arch

    opt = dict({"train_ps": 128}, **opt)
    jmodel = jax_get_arch(dict(opt, attn_backend="jnp"))
    cfg = arch_config(opt)
    for k in ("img_size", "embed_dim", "depths", "num_heads", "win_size",
              "mlp_ratio", "modulator", "shift_flag", "dd_in",
              "drop_path_rate"):
        assert tuple(np.atleast_1d(getattr(jmodel, k))) == \
            tuple(np.atleast_1d(cfg[k])), k
    assert jmodel.token_projection == "linear"
    assert jmodel.token_mlp in ("leff", "fastleff")

    x = np.random.default_rng(0).uniform(0, 1, (1, 128, 128, 3)) \
        .astype(np.float32)
    full = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.asarray(x))
    Uformer(**cfg).load_state_dict(
        {k: torch.from_numpy(np.array(v))
         for k, v in state_dict_from_jax(_seeded(jax, full, 1)).items()},
        strict=True)

    shallow = jmodel.clone(depths=SHALLOW)
    params = _seeded(jax, jax.eval_shape(
        shallow.init, jax.random.PRNGKey(0), jnp.asarray(x)), 2)
    want = np.asarray(jax.jit(shallow.apply)(params, jnp.asarray(x)))
    port = Uformer(**dict(cfg, depths=SHALLOW)).eval()
    port.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                          state_dict_from_jax(params).items()}, strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * (1 + np.abs(want).max()))
