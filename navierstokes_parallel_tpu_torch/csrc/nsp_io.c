/* Native text-field writer of the port (utils/io.py), byte-identical to
 * the reference's output() (src/serial/io.c:61-120) and to the port's
 * Python formatter utils/io.py::_write_grid_py, which the tests hold it
 * against.  A Python formatter takes seconds for one 2048^2 field; this one
 * formats "%.5f" by hand, in fixed point.
 *
 * Exactness of the fast path (|v| < 1e10): the exact product v * 1e5 is
 * recovered as p + e with BOTH terms exact (e = fma(v, 1e5, -p), the
 * 2ProdFMA residual); p < 1e15 < 2^53 makes (double)llround(p) and the
 * cancellations (p - n) -+ 0.5 exact, so every comparison against the
 * rounding boundaries n -+ 0.5 is decided without any floating-point
 * rounding.  Exact ties (v = (2m+1)/(2*10^5) dyadic, e.g. 0.078125 = 5/64,
 * which happens whenever 5^5 divides the odd numerator) are resolved to
 * even like glibc/Python do.  Larger magnitudes, NaN and Inf fall back to
 * snprintf.  Python's "%.5f" and glibc's printf are both correctly rounded,
 * so the writers agree byte-for-byte.  Built with -ffp-contract=off, so the
 * compiler fuses none of these products and sums.
 */

#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

/* Max "%.5f" width: DBL_MAX has 309 integer digits + sign + '.' + 5 + NUL.
 * Every buffer slot is sized to this so the snprintf fallback can never
 * overrun; the return is clamped anyway in case of future format drift. */
#define FMT5_MAX 320

/* Format v as "%.5f" into out (>= FMT5_MAX bytes); returns chars written. */
static size_t fmt5(char *out, double v) {
    if (!(v == v)) {
        /* Python's "%.5f" writes "nan" regardless of the sign bit; glibc's
         * snprintf writes "-nan" for sign-bit-set NaNs — emit "nan"
         * unconditionally so diverged-solve frames keep byte parity. */
        memcpy(out, "nan", 3);
        return 3;
    }
    if (v >= 1e10 || v <= -1e10) {
        int r = snprintf(out, FMT5_MAX, "%.5f", v);
        if (r < 0)
            r = 0;
        else if (r >= FMT5_MAX)
            r = FMT5_MAX - 1;
        return (size_t)r;
    }

    double p = v * 1e5;
    long long n = llround(p);
    /* exact(v*1e5) - n = d + e with BOTH terms exact; comparing
     * (d -+ 0.5) against -e (each side exact) avoids the lossy sum d + e,
     * which absorbed half-ulp residuals exactly at the tie boundary. */
    double e = fma(v, 1e5, -p);
    double d = p - (double)n;
    double hi = d - 0.5; /* exact - (n + 0.5) = hi + e */
    double lo = d + 0.5; /* exact - (n - 0.5) = lo + e */
    if (hi > -e) n++;                       /* above n + 0.5 */
    else if (hi == -e) n += (n & 1LL) ? 1 : 0; /* tie at n + 0.5: to even */
    else if (lo < -e) n--;                  /* below n - 0.5 */
    else if (lo == -e) n -= (n & 1LL) ? 1 : 0; /* tie at n - 0.5: to even */

    char *s = out;
    int neg = signbit(v) != 0; /* printf keeps the sign of -0.00000... */
    unsigned long long k = (unsigned long long)(n < 0 ? -n : n);
    if (neg)
        *s++ = '-';

    unsigned long long ip = k / 100000ull;
    unsigned long long fp = k % 100000ull;

    char tmp[24];
    int ti = 0;
    do {
        tmp[ti++] = (char)('0' + (ip % 10ull));
        ip /= 10ull;
    } while (ip);
    while (ti)
        *s++ = tmp[--ti];

    *s++ = '.';
    s[4] = (char)('0' + fp % 10); fp /= 10;
    s[3] = (char)('0' + fp % 10); fp /= 10;
    s[2] = (char)('0' + fp % 10); fp /= 10;
    s[1] = (char)('0' + fp % 10); fp /= 10;
    s[0] = (char)('0' + fp);
    return (size_t)(s + 5 - out);
}

/* Write one grid file in the reference format: 3-line header (t, a, b as
 * "%.5f"), then nj text rows — row j holds arr[i, j] for i in [0, n_cols)
 * ("%.5f " each) when j < n_rows, an empty line otherwise (the v-file
 * quirk).  arr is row-major (ni, nj), indexed arr[i*nj + j].
 * Returns 0 on success. */
int nsp_write_grid(const char *path, const double *arr, int ni, int nj,
                   int n_cols, int n_rows, double t, double a, double b) {
    if (n_cols > ni)
        return 4;
    FILE *f = fopen(path, "w");
    if (!f)
        return 1;
    char *buf = (char *)malloc(((size_t)n_cols + 1) * (FMT5_MAX + 1) + 8);
    if (!buf) {
        fclose(f);
        return 2;
    }
    size_t off = 0;
    off += fmt5(buf + off, t); buf[off++] = '\n';
    off += fmt5(buf + off, a); buf[off++] = '\n';
    off += fmt5(buf + off, b); buf[off++] = '\n';
    fwrite(buf, 1, off, f);

    for (int j = 0; j < nj; j++) {
        if (j < n_rows) {
            off = 0;
            for (int i = 0; i < n_cols; i++) {
                off += fmt5(buf + off, arr[(size_t)i * (size_t)nj + j]);
                buf[off++] = ' ';
            }
            buf[off++] = '\n';
            fwrite(buf, 1, off, f);
        } else {
            fputc('\n', f);
        }
    }
    free(buf);
    /* A mid-file fwrite can fail (e.g. ENOSPC) while the final fclose flush
     * succeeds; ferror catches it so truncated files never return 0. */
    int bad = ferror(f);
    if (fclose(f) || bad)
        return 3;
    return 0;
}
