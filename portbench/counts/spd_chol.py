"""Work of the batched SPD kernels (csrc/spd_chol.cu): the factor and the
substitution, each input counted once and each output once, at the bytes
and operations the algorithm needs (the lower triangle it reads and
writes, not the whole square the kernel moves).

Operations count a multiply-add as 2, a multiply, division, reciprocal or
square root as 1.  The factor of an n x n matrix: column j takes j
multiply-adds for its diagonal and j for each of the n-1-j entries below
it, (n^3 - n)/6 in all, one multiply by 1/L_jj for each entry below the
diagonal, and a square root and a reciprocal for each diagonal.  The
substitution of k right-hand sides: forward and back, each i multiply-adds
and one multiply by 1/L_ii for row i: 2 n^2 operations a column.
"""

# (n, k) of each SPD kernel on the closed loop's tick: the WBC's 30 x 30
# H and S_eq (H^-1 A' with 30 columns, the KKT right-hand sides one at a
# time) and the physics' 18 x 18 mass matrix, by (kernel, its compile-time
# width N); tests/test_counts.py holds it to the tick's calls
TICK_SHAPES = {
    ("spd_factor_kernel", 30): (30, 0),
    ("spd_sub_rows_kernel", 30): (30, 1),
    ("spd_sub_cols_kernel", 30): (30, 30),
    ("spd_factor_kernel", 18): (18, 0),
    ("spd_sub_rows_kernel", 18): (18, 1),
}


def factor_work(B: int, n: int) -> tuple[float, float]:
    """(bytes, operations) of factoring B matrices n x n."""
    flops = (n ** 3 - n) / 3 + n * (n - 1) / 2 + 2 * n
    nbytes = 4 * (n * (n + 1) // 2          # H, lower triangle
                  + n * (n + 1) // 2 + n)   # L, lower triangle; 1 / L_ii
    return float(B * nbytes), float(B * flops)


def sub_work(B: int, n: int, k: int) -> tuple[float, float]:
    """(bytes, operations) of solving L L' X = R for B matrices, n x n,
    and k right-hand sides each."""
    nbytes = 4 * (n * (n - 1) // 2 + n      # L strictly lower; 1 / L_ii
                  + 2 * n * k)              # R in, X out
    return float(B * nbytes), float(B * 2 * n * n * k)


def kernel_work(kernel: str, N: int, B: int) -> tuple[float, float]:
    """(bytes, operations) of one launch of the tick's `kernel`<N> over a
    batch of B."""
    n, k = TICK_SHAPES[(kernel, N)]
    return factor_work(B, n) if kernel == "spd_factor_kernel" else \
        sub_work(B, n, k)
