"""negotiation positive: wire stamps with no advertisement check."""

from brpc_tpu_torch.runtime import codec as codec_mod
from brpc_tpu_torch.runtime import native


class Client:
    def pull(self, channel, name):
        with native.qos(native.PRIORITY_HIGH, 0):  # never advertised
            return channel.call("ParamService/PullQ", name.encode())

    def push(self, channel, name, host):
        enc = codec_mod.encode(host, "int8")
        return channel.call("ParamService/Push", name.encode(), enc)
