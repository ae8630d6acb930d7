"""plain_torch_ms.batch (ops, device trace): device ms a frame of every
kernel that is not one of the program's hand-written kernels
(kernels/*.json): census, the flow cost build, the tail and the pyramid
in PyTorch's own kernels.  Copies and memsets are not kernels."""


def read(run):
    return run.trace.kernel_s(None) * 1e3 / run.trace.frames
