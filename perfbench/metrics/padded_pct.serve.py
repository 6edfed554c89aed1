"""padded_pct.serve: Padding's share of the batches' slots in the window:
padded_slots / (requests + padded_slots) (program_counter)."""

from perfbench.core import readers

read = readers.padded_pct
