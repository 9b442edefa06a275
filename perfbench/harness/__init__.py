"""The general harness: it finds configurations, traffic mixes, metric
readers and kernel counts by the names in BENCHMARK.json."""
