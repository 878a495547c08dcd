"""state-machine negative: locked, legal transitions and the handshake
in order."""

from brpc_tpu_torch.serving.session import ACTIVE, DONE, QUEUED


class Manager:
    def activate(self, sess):
        with self._mu:
            if sess.state == QUEUED:
                sess.state = ACTIVE

    def finish(self, sess):
        with self._mu:
            if sess.state == ACTIVE:
                sess.state = DONE


def migrate(client, name):
    client.handoff(name)
    client.install(name, None, 1)
    client.retire(name)
    client.commit(name)
