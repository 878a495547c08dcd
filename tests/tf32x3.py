"""3xTF32 arithmetic emulated in torch, for the CPU tests of the port's
fp32 tensor-core kernels (K3's ``flash_tf32x3_kernel``, the MLA pair).

Each operand x is split into big = x rounded to TF32 (10 mantissa bits, to
nearest, ties away from zero: ``cvt.rna.tf32.f32``'s rule, done on an int32
view of the bits) and small = x - big, of which the tensor core reads the
top 19 bits (truncation). Products use ``@``, so a test may monkeypatch
``torch.matmul`` with them.
"""

import torch


def rna(x):
    """x rounded to TF32 as cvt.rna.tf32.f32 rounds it (finite x): half an
    ulp added to the magnitude's bits, the low 13 bits dropped."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def trunc(x):
    """x with its low 13 bits dropped, as the tensor core reads a TF32
    operand."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(x):
    big = rna(x)
    return big, trunc(x - big)


def mm_3xtf32(a, b, apart=False):
    """a @ b as the kernels take it: for each 8 of the shared dimension,
    small.big + big.small + big.big into the fp32 accumulator, or with
    ``apart`` the cross terms into one and big.big into another, summed at
    the end."""
    a_big, a_small = split(a)
    b_big, b_small = split(b)
    c = torch.zeros(*a.shape[:-1], b.shape[-1], dtype=torch.float32)
    cross = torch.zeros_like(c)
    for k0 in range(0, a.shape[-1], 8):
        ka, kb = (..., slice(k0, k0 + 8)), (..., slice(k0, k0 + 8),
                                             slice(None))
        if apart:
            cross = cross + a_small[ka] @ b_big[kb]
            cross = cross + a_big[ka] @ b_small[kb]
        else:
            c = c + a_small[ka] @ b_big[kb]
            c = c + a_big[ka] @ b_small[kb]
        c = c + a_big[ka] @ b_big[kb]
    return c + cross


def mm_1xtf32(a, b, apart=False):
    """a @ b in plain TF32: one product of the rounded operands."""
    del apart
    return rna(a) @ rna(b)
