"""copy_ms.serve: Mean of the program's serve.copy spans (a batch's
torch.from_numpy(...).to(device), pageable) over the batches of the traced
slice, in ms (program_span)."""

from perfbench.core import program_spans


def read(run):
    return program_spans.mean_ms(run, "serve.copy")
