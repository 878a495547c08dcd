"""The port's codec against the JAX package's: the same wire, byte for byte.

Inputs are numpy arrays from a seed; both codecs encode them and the
wires (scales + codes) and headers must be identical, decode must give
identical values, and error-feedback residuals must stay identical over
a stream of pushes. Tolerance 0 throughout: the port's codec is the same
numpy arithmetic, with the e4m3 rounding done by torch instead of
ml_dtypes (both round to nearest even).
"""

import numpy as np
import pytest

from brpc_tpu.runtime import codec as jcodec
from brpc_tpu.runtime import groupwire as jgroup
from brpc_tpu_torch.runtime import codec as tcodec
from brpc_tpu_torch.runtime import groupwire as tgroup

CODECS = ["int8", "fp8e4m3"]


def _x(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("shape,block", [((64, 256), 256),
                                         ((37, 300), 256),
                                         ((5000,), 128)])
def test_encode_wire_is_byte_identical(codec, shape, block):
    x = _x(shape, seed=len(shape) + block)
    x.reshape(-1)[:block] = 0.0  # an all-zero block: zero scale, zero codes
    je = jcodec.encode(x, codec, block=block)
    te = tcodec.encode(x, codec, block=block)
    assert te.header == je.header
    np.testing.assert_array_equal(te.wire, je.wire)
    np.testing.assert_array_equal(te.dequantized(), je.dequantized())


@pytest.mark.parametrize("codec", CODECS)
def test_decode_and_split_match(codec):
    x = _x((3000,), seed=5, scale=7.0)
    enc = jcodec.encode(x, codec)
    meta = {"dtype": "<f4", "shape": [3000], "codec": codec,
            "block": enc.block}
    np.testing.assert_array_equal(tcodec.decode(meta, enc.wire),
                                  jcodec.decode(meta, enc.wire))
    jq, js = jcodec.split_wire(meta, enc.wire)
    tq, ts = tcodec.split_wire(meta, enc.wire)
    np.testing.assert_array_equal(ts, js)
    assert tq.view(np.uint8).tobytes() == jq.view(np.uint8).tobytes()
    # e4m3 codes ride as their raw bytes in the port's views.
    assert tq.dtype == (np.int8 if codec == "int8" else np.uint8)
    with pytest.raises(ValueError):
        tcodec.split_wire(meta, enc.wire[:-1])
    np.testing.assert_array_equal(
        tcodec.error_bound(meta, ts), jcodec.error_bound(meta, js))


def test_eligibility_and_negotiation_match():
    for x in (np.zeros(1024, np.float32), np.zeros(1023, np.float32),
              np.zeros(4096, np.float64), np.zeros(4096, np.int32)):
        assert tcodec.eligible(x) == jcodec.eligible(x)
    for req in (None, "int8", "fp8e4m3", "zstd"):
        for adv in (None, (), ("int8",), ("int8", "fp8e4m3")):
            assert tcodec.choose(req, adv) == jcodec.choose(req, adv)
    assert set(tcodec.supported_codecs()) == {"int8", "fp8e4m3"}


@pytest.mark.parametrize("codec", CODECS)
def test_error_feedback_residuals_match_over_ten_pushes(codec):
    jef, tef = jcodec.ErrorFeedback(), tcodec.ErrorFeedback()
    for k in range(10):
        g = _x((40, 96), seed=100 + k, scale=0.01 * (k + 1))
        wires = []
        for ef, mod in ((jef, jcodec), (tef, tcodec)):
            x = ef.compensate("w", g)
            e = mod.encode(x, codec)
            ef.settle("w", x, e.dequantized())
            wires.append(e.wire)
        np.testing.assert_array_equal(wires[1], wires[0])
        np.testing.assert_array_equal(tef.residual("w"), jef.residual("w"))


def test_group_frame_is_byte_identical():
    entries = [{"name": "a", "dtype": "<f4", "shape": [4]},
               {"name": "b", "code": 2040, "error": "no such parameter: b"},
               {"name": "c", "dtype": "<f4", "shape": [3]}]
    blobs = [_x((4,), 1), None, _x((3,), 2)]
    jm, jc = jgroup.pack_group(entries, blobs)
    tm, tc = tgroup.pack_group(entries, blobs)
    assert tm == jm
    np.testing.assert_array_equal(tc, jc)
    runs = list(tgroup.split_group(tgroup.parse_group(tm), tc))
    assert runs[1][1] is None
    np.testing.assert_array_equal(runs[2][1].view(np.float32), blobs[2])
