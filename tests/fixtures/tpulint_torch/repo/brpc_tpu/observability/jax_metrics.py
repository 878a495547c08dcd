"""The JAX package's side of the one shared registry (fixture)."""

from brpc_tpu.observability import metrics as obs

obs.counter("fixture_shared_series")
