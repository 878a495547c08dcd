"""state-machine positive: an unlocked state write, a resurrect past a
terminal state, and the migration legs out of order."""

from brpc_tpu_torch.serving.session import ACTIVE, DONE


class Manager:
    def activate_racy(self, sess):
        sess.state = ACTIVE  # outside the manager lock

    def resurrect(self, sess):
        with self._mu:
            if sess.state == DONE:
                sess.state = ACTIVE  # DONE is terminal


def migrate(client, name):
    client.install(name, None, 1)
    client.commit(name)
    client.retire(name)
