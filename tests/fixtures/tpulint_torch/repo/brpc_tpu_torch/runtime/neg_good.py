"""negotiation negative: each stamp behind its advertisement."""

from brpc_tpu_torch.runtime import codec as codec_mod
from brpc_tpu_torch.runtime import native


class Client:
    def pull(self, channel, name):
        if not self._srv_qos:
            return channel.call("ParamService/Pull", name.encode())
        with native.qos(native.PRIORITY_HIGH, 0):
            return channel.call("ParamService/Pull", name.encode())

    def push(self, channel, name, host):
        c = self.negotiated_codec()
        enc = codec_mod.encode(host, c) if c else host
        return channel.call("ParamService/Push", name.encode(), enc)
