"""metric-namespace-torch negative: prefixed names, and a stdlib
Counter that is no metric."""

import collections

from brpc_tpu_torch.observability import metrics as obs

obs.gauge("torch_fixture_depth", lambda: 0)
tally = collections.Counter("abc")
