"""metric-name negative: distinct, well-formed port names."""

from brpc_tpu_torch.observability import metrics as obs

obs.counter("torch_fixture_pulls")
obs.latency("torch_fixture_pull")
