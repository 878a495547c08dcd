"""error-code positive: two names on one value, a structural code outside
its band, and a raw literal where a name exists."""

E_FIXTURE_GONE = 2093
E_FIXTURE_AWAY = 2093
E_FIXTURE_LOW = 1500


def busy(err):
    return err.code == 2091
