"""The benchmark's frozen yardstick: discovery of cells, configurations,
drivers and metric readers by name (common), weights and traffic from
the seed (weights, traffic), statistics (stats), the
profiler trace's reduction (trace), the FLOP and byte count (counts) and
the comparison that decides `correct` (compare)."""
