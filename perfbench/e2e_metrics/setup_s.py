"""setup_s: process start to the first timed call (imports, CUDA
initialization, the program's kernel builds where the checkout has none,
the decoder's or encoder's construction, the warm-up calls), less the
seconds the benchmark spent making its corpus."""


def read(run):
    return run.setup_s
