import jax

# fp64 for the ranking oracles (models pass explicit fp32/bf16 dtypes, so
# they are unaffected). Do NOT set XLA_FLAGS here — smoke tests and benches
# must see the real single-device CPU; dry-run spawns its own process.
jax.config.update("jax_enable_x64", True)

# Property-test modules import hypothesis at module level; on bare
# environments install the deterministic fallback so tier-1 still collects
# (and exercises) all modules. The real package wins when present.
try:
    import hypothesis  # noqa: F401
except ImportError:
    from _hypothesis_fallback import install as _install_hypothesis_fallback

    _install_hypothesis_fallback()


def pytest_configure(config):
    # tests of the PyTorch/CUDA port's kernels on the card; each skips
    # (from inside the test) when torch sees no CUDA device
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips without one")
