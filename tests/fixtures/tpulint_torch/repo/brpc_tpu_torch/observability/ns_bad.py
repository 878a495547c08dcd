"""metric-namespace-torch positive: a port series without torch_."""

from brpc_tpu_torch.observability import metrics as obs

obs.gauge("fixture_unprefixed_depth", lambda: 0)
