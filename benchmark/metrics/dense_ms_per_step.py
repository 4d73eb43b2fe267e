"""Device milliseconds per outer step in cuBLAS and CUTLASS products (GEMM,
GEMV and split-K kernels, by name): the body model, the regressor and the
priors."""

from benchmark import trace


def read(ctx):
    if ctx.trace.steps == 0:
        return None
    seconds = trace.seconds_where(ctx.trace.ops, lambda n: trace.DENSE.search(n) is not None)
    return 1e3 * seconds / ctx.trace.steps if seconds > 0 else None
