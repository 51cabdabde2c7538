"""The benchmark's yardstick: traffic generation, seeded weights, operation
and byte counts, the reduction of a profiler trace, and one runner per kind
of traffic (``kinds/``)."""
