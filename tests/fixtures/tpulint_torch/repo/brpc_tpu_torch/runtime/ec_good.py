"""error-code negative: one value per name, inside the structural band,
compared by name."""

E_FIXTURE_MOVED = 2090
E_FIXTURE_BUSY = 2091


def moved(err):
    return err.code == E_FIXTURE_MOVED
