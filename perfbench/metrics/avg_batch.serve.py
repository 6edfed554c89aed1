"""avg_batch.serve: Requests per batch the server ran in the window:
ServerStats.requests / batches (program_counter)."""

from perfbench.core import readers

read = readers.avg_batch
