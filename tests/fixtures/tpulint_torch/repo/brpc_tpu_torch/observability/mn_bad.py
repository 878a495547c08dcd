"""metric-name positive: a name outside the exposition charset, and a
port series that takes a JAX series' name."""

from brpc_tpu_torch.observability import metrics as obs

obs.counter("torch_bad-name")
obs.counter("fixture_shared_series")  # the JAX package's name
