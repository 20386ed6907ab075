"""Shared by the port's speaker-tool tests: the JAX speaker encoder's
seeded variables, which ``interop/convert.py::speaker_encoder_state_dict``
carries to the port's encoder."""
import jax
import jax.numpy as jnp
import numpy as np

from xva_trainer_tpu.models.speaker_encoder import ResNetSpeakerEncoder as JaxEncoder


def seeded_variables(seed=0):
    """The JAX encoder's variables: kernels N(0, 1/fan_in), BatchNorm scales
    1 + N(0, 0.1), running variances in [1, 1.5), biases 0 (so that the
    embedding follows its input), the rest N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(JaxEncoder().init, jax.random.PRNGKey(0), jnp.zeros((1, 16000)))

    def leaf(path, s):
        name = getattr(path[-1], "key", "")
        if name == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(
                np.float32)
        if name == "var":
            return (1.0 + 0.5 * rng.random(s.shape)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == "bias":
            return np.zeros(s.shape, np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map(np.asarray, jax.tree_util.tree_map_with_path(leaf, shapes))
