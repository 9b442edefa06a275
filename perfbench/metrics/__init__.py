"""One reader a per-layer metric, in a file named after the metric.

Each file defines ``read(run)``, which takes the metric from the run's
spans, counters or device trace (:class:`perfbench.harness.driver.Run`)
and returns a number, or None where the run has nothing to read.
"""
