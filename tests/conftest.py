import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.RandomState(0)


def make_batch(cfg, B, S, seed=0):
    """Input batch for any arch family (tokens / stub embeds / enc-dec)."""
    import jax.numpy as jnp
    r = np.random.RandomState(seed)
    b = {}
    if cfg.is_encoder_decoder:
        b["enc_embeds"] = jnp.asarray(r.randn(B, S, cfg.d_model), jnp.float32)
        b["tokens"] = jnp.asarray(r.randint(0, cfg.vocab_size, (B, S)), jnp.int32)
    elif cfg.frontend_stub:
        b["embeds"] = jnp.asarray(r.randn(B, S, cfg.d_model), jnp.float32)
        if cfg.vocab_size > 0:
            b["labels"] = jnp.asarray(r.randint(0, cfg.vocab_size, (B, S)), jnp.int32)
        if cfg.mrope_sections:
            b["pos3"] = jnp.tile(jnp.arange(S, dtype=jnp.int32)[None, :, None],
                                 (B, 1, 3))
    else:
        b["tokens"] = jnp.asarray(r.randint(0, cfg.vocab_size, (B, S)), jnp.int32)
    return b


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA GPU (the port's kernels run only on the "
        "card); skips elsewhere with its reason")
