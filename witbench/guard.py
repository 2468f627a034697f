"""What the process that prints the result must not have loaded.

The JAX package (`circom_tpu`) and JAX itself never run in a benchmark:
after the window, the modules the process holds are compared with these
names by their top-level name, the part before the first dot, whole, so
that `circom_tpu_torch` (the port) is not taken for `circom_tpu`.
"""

FORBIDDEN = ("jax", "jaxlib", "flax", "circom_tpu")


def top_level(name):
    return name.split(".", 1)[0]


def forbidden_loaded(modules):
    """The sorted names among `modules` (names, e.g. sys.modules) whose
    top-level name is a forbidden one."""
    return sorted(m for m in modules if top_level(m) in FORBIDDEN)
