// OpenSimplex fractal noise — native CPU kernel (C++/OpenMP).
//
// Role: the reference's only compiled component is a set of numba-JIT'd
// OpenSimplex kernels (reference src/utils/simplex_noise.py:559-1293, itself from
// the public-domain OpenSimplex algorithm by Kurt Spencer). numba is a CPU LLVM JIT;
// the TPU framework's native equivalent is this C++ kernel (OpenMP-parallel over
// rows) exposed via a C ABI and bound with ctypes (ddpm_ood_tpu/noise/_native.py).
// An on-device JAX path lives in ddpm_ood_tpu/noise/simplex.py; this kernel is the
// host-side parity/throughput path.
//
// Implementation: standard public-domain OpenSimplex 2D/3D (stretch/squish lattice,
// contribution-based), with the 64-bit LCG permutation initialisation
// (seed*6364136223846793005+1442695040888963407, three warm-up iterations then a
// Fisher-Yates-style draw) matching the reference's _init
// (simplex_noise.py:559-577) so seeds reproduce the same lattices.
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC (see noise/_native.py).

#include <cstdint>
#include <cmath>
#include <cstring>

namespace {

constexpr double STRETCH2 = -0.211324865405187;  // (1/sqrt(2+1)-1)/2
constexpr double SQUISH2 = 0.366025403784439;    // (sqrt(2+1)-1)/2
constexpr double STRETCH3 = -1.0 / 6.0;          // (1/sqrt(3+1)-1)/3
constexpr double SQUISH3 = 1.0 / 3.0;            // (sqrt(3+1)-1)/3
constexpr double NORM2 = 47.0;
constexpr double NORM3 = 103.0;

const int8_t GRADIENTS2[16] = {
    5, 2, 2, 5, -5, 2, -2, 5, 5, -2, 2, -5, -5, -2, -2, -5,
};

const int8_t GRADIENTS3[72] = {
    -11, 4,  4,  -4,  11, 4,  -4,  4,  11, 11, 4,  4,  4,  11, 4,  4,  4,  11,
    -11, -4, 4,  -4,  -11, 4, -4,  -4, 11, 11, -4, 4,  4,  -11, 4, 4,  -4, 11,
    -11, 4,  -4, -4,  11, -4, -4,  4,  -11, 11, 4, -4, 4,  11, -4, 4,  4,  -11,
    -11, -4, -4, -4, -11, -4, -4, -4, -11, 11, -4, -4, 4, -11, -4, 4, -4, -11,
};

struct Ctx {
    int16_t perm[256];
    int16_t perm_grad3[256];
};

inline int64_t lcg(int64_t s) {
    // two's-complement wraparound == the reference's ctypes c_int64 overflow hack
    return (int64_t)((uint64_t)s * 6364136223846793005ULL + 1442695040888963407ULL);
}

void init_ctx(Ctx* ctx, int64_t seed) {
    int16_t source[256];
    for (int i = 0; i < 256; i++) source[i] = (int16_t)i;
    seed = lcg(lcg(lcg(seed)));
    for (int i = 255; i >= 0; i--) {
        seed = lcg(seed);
        int r = (int)((seed + 31) % (i + 1));
        if (r < 0) r += i + 1;
        ctx->perm[i] = source[r];
        ctx->perm_grad3[i] = (int16_t)((ctx->perm[i] % (72 / 3)) * 3);
        source[r] = source[i];
    }
}

inline double extrapolate2(const Ctx* c, int xsb, int ysb, double dx, double dy) {
    int index = c->perm[(c->perm[xsb & 0xFF] + ysb) & 0xFF] & 0x0E;
    return GRADIENTS2[index] * dx + GRADIENTS2[index + 1] * dy;
}

inline double extrapolate3(const Ctx* c, int xsb, int ysb, int zsb, double dx,
                           double dy, double dz) {
    int index = c->perm_grad3[(c->perm[(c->perm[xsb & 0xFF] + ysb) & 0xFF] + zsb) & 0xFF];
    return GRADIENTS3[index] * dx + GRADIENTS3[index + 1] * dy +
           GRADIENTS3[index + 2] * dz;
}

inline double ffloor(double x) { return std::floor(x); }

double noise2(const Ctx* c, double x, double y) {
    double stretch = (x + y) * STRETCH2;
    double xs = x + stretch, ys = y + stretch;
    int xsb = (int)ffloor(xs), ysb = (int)ffloor(ys);
    double squish = (xsb + ysb) * SQUISH2;
    double xb = xsb + squish, yb = ysb + squish;
    double xins = xs - xsb, yins = ys - ysb;
    double in_sum = xins + yins;
    double dx0 = x - xb, dy0 = y - yb;
    double value = 0;

    // contribution (1,0)
    double dx1 = dx0 - 1 - SQUISH2, dy1 = dy0 - 0 - SQUISH2;
    double attn1 = 2 - dx1 * dx1 - dy1 * dy1;
    if (attn1 > 0) {
        attn1 *= attn1;
        value += attn1 * attn1 * extrapolate2(c, xsb + 1, ysb, dx1, dy1);
    }
    // contribution (0,1)
    double dx2 = dx0 - 0 - SQUISH2, dy2 = dy0 - 1 - SQUISH2;
    double attn2 = 2 - dx2 * dx2 - dy2 * dy2;
    if (attn2 > 0) {
        attn2 *= attn2;
        value += attn2 * attn2 * extrapolate2(c, xsb, ysb + 1, dx2, dy2);
    }

    double dx_ext, dy_ext;
    int xsv_ext, ysv_ext;
    if (in_sum <= 1) {  // inside the triangle (2-simplex) at (0,0)
        double zins = 1 - in_sum;
        if (zins > xins || zins > yins) {
            if (xins > yins) {
                xsv_ext = xsb + 1; ysv_ext = ysb - 1;
                dx_ext = dx0 - 1; dy_ext = dy0 + 1;
            } else {
                xsv_ext = xsb - 1; ysv_ext = ysb + 1;
                dx_ext = dx0 + 1; dy_ext = dy0 - 1;
            }
        } else {
            xsv_ext = xsb + 1; ysv_ext = ysb + 1;
            dx_ext = dx0 - 1 - 2 * SQUISH2; dy_ext = dy0 - 1 - 2 * SQUISH2;
        }
    } else {  // inside the triangle at (1,1)
        double zins = 2 - in_sum;
        if (zins < xins || zins < yins) {
            if (xins > yins) {
                xsv_ext = xsb + 2; ysv_ext = ysb;
                dx_ext = dx0 - 2 - 2 * SQUISH2; dy_ext = dy0 - 2 * SQUISH2;
            } else {
                xsv_ext = xsb; ysv_ext = ysb + 2;
                dx_ext = dx0 - 2 * SQUISH2; dy_ext = dy0 - 2 - 2 * SQUISH2;
            }
        } else {
            xsv_ext = xsb; ysv_ext = ysb;
            dx_ext = dx0; dy_ext = dy0;
        }
        xsb += 1; ysb += 1;
        dx0 = dx0 - 1 - 2 * SQUISH2; dy0 = dy0 - 1 - 2 * SQUISH2;
    }

    // contribution (0,0) or (1,1)
    double attn0 = 2 - dx0 * dx0 - dy0 * dy0;
    if (attn0 > 0) {
        attn0 *= attn0;
        value += attn0 * attn0 * extrapolate2(c, xsb, ysb, dx0, dy0);
    }
    // extra vertex
    double attn_ext = 2 - dx_ext * dx_ext - dy_ext * dy_ext;
    if (attn_ext > 0) {
        attn_ext *= attn_ext;
        value += attn_ext * attn_ext * extrapolate2(c, xsv_ext, ysv_ext, dx_ext, dy_ext);
    }
    return value / NORM2;
}

double noise3(const Ctx* c, double x, double y, double z) {
    double stretch = (x + y + z) * STRETCH3;
    double xs = x + stretch, ys = y + stretch, zs = z + stretch;
    int xsb = (int)ffloor(xs), ysb = (int)ffloor(ys), zsb = (int)ffloor(zs);
    double squish = (xsb + ysb + zsb) * SQUISH3;
    double xb = xsb + squish, yb = ysb + squish, zb = zsb + squish;
    double xins = xs - xsb, yins = ys - ysb, zins = zs - zsb;
    double in_sum = xins + yins + zins;
    double dx0 = x - xb, dy0 = y - yb, dz0 = z - zb;

    double dx_ext0, dy_ext0, dz_ext0, dx_ext1, dy_ext1, dz_ext1;
    int xsv_ext0, ysv_ext0, zsv_ext0, xsv_ext1, ysv_ext1, zsv_ext1;
    double value = 0;

    if (in_sum <= 1) {  // inside the tetrahedron at (0,0,0)
        // which two of (0,0,1),(0,1,0),(1,0,0) are closest
        uint8_t a_point = 0x01, b_point = 0x02;
        double a_score = xins, b_score = yins;
        if (a_score >= b_score && zins > b_score) {
            b_score = zins; b_point = 0x04;
        } else if (a_score < b_score && zins > a_score) {
            a_score = zins; a_point = 0x04;
        }
        // extra vertices depend on closest in-region points
        double wins = 1 - in_sum;
        if (wins > a_score || wins > b_score) {  // (0,0,0) is a closest
            uint8_t closest = (b_score > a_score) ? b_point : a_point;
            if (closest & 0x01) {
                xsv_ext0 = xsb + 1; ysv_ext0 = ysb - 1; zsv_ext0 = zsb;
                dx_ext0 = dx0 - 1; dy_ext0 = dy0 + 1; dz_ext0 = dz0;
                xsv_ext1 = xsb + 1; ysv_ext1 = ysb; zsv_ext1 = zsb - 1;
                dx_ext1 = dx0 - 1; dy_ext1 = dy0; dz_ext1 = dz0 + 1;
            } else if (closest & 0x02) {
                xsv_ext0 = xsb - 1; ysv_ext0 = ysb + 1; zsv_ext0 = zsb;
                dx_ext0 = dx0 + 1; dy_ext0 = dy0 - 1; dz_ext0 = dz0;
                xsv_ext1 = xsb; ysv_ext1 = ysb + 1; zsv_ext1 = zsb - 1;
                dx_ext1 = dx0; dy_ext1 = dy0 - 1; dz_ext1 = dz0 + 1;
            } else {
                xsv_ext0 = xsb - 1; ysv_ext0 = ysb; zsv_ext0 = zsb + 1;
                dx_ext0 = dx0 + 1; dy_ext0 = dy0; dz_ext0 = dz0 - 1;
                xsv_ext1 = xsb; ysv_ext1 = ysb - 1; zsv_ext1 = zsb + 1;
                dx_ext1 = dx0; dy_ext1 = dy0 + 1; dz_ext1 = dz0 - 1;
            }
        } else {  // (0,0,0) is not closest: extra vertices from the two closest
            uint8_t closest = (uint8_t)(a_point | b_point);
            if (closest == 0x03) {  // (1,1,0)
                xsv_ext0 = xsb + 1; ysv_ext0 = ysb + 1; zsv_ext0 = zsb - 1;
                dx_ext0 = dx0 - 1 - SQUISH3; dy_ext0 = dy0 - 1 - SQUISH3; dz_ext0 = dz0 + 1 - SQUISH3;
                xsv_ext1 = xsb + 1; ysv_ext1 = ysb + 1; zsv_ext1 = zsb;
                dx_ext1 = dx0 - 1 - 2 * SQUISH3; dy_ext1 = dy0 - 1 - 2 * SQUISH3; dz_ext1 = dz0 - 2 * SQUISH3;
            } else if (closest == 0x05) {  // (1,0,1)
                xsv_ext0 = xsb + 1; ysv_ext0 = ysb - 1; zsv_ext0 = zsb + 1;
                dx_ext0 = dx0 - 1 - SQUISH3; dy_ext0 = dy0 + 1 - SQUISH3; dz_ext0 = dz0 - 1 - SQUISH3;
                xsv_ext1 = xsb + 1; ysv_ext1 = ysb; zsv_ext1 = zsb + 1;
                dx_ext1 = dx0 - 1 - 2 * SQUISH3; dy_ext1 = dy0 - 2 * SQUISH3; dz_ext1 = dz0 - 1 - 2 * SQUISH3;
            } else {  // 0x06: (0,1,1)
                xsv_ext0 = xsb - 1; ysv_ext0 = ysb + 1; zsv_ext0 = zsb + 1;
                dx_ext0 = dx0 + 1 - SQUISH3; dy_ext0 = dy0 - 1 - SQUISH3; dz_ext0 = dz0 - 1 - SQUISH3;
                xsv_ext1 = xsb; ysv_ext1 = ysb + 1; zsv_ext1 = zsb + 1;
                dx_ext1 = dx0 - 2 * SQUISH3; dy_ext1 = dy0 - 1 - 2 * SQUISH3; dz_ext1 = dz0 - 1 - 2 * SQUISH3;
            }
        }

        // contribution (0,0,0)
        double attn0 = 2 - dx0 * dx0 - dy0 * dy0 - dz0 * dz0;
        if (attn0 > 0) {
            attn0 *= attn0;
            value += attn0 * attn0 * extrapolate3(c, xsb, ysb, zsb, dx0, dy0, dz0);
        }
        // contribution (1,0,0)
        double dx1 = dx0 - 1 - SQUISH3, dy1 = dy0 - SQUISH3, dz1 = dz0 - SQUISH3;
        double attn1 = 2 - dx1 * dx1 - dy1 * dy1 - dz1 * dz1;
        if (attn1 > 0) {
            attn1 *= attn1;
            value += attn1 * attn1 * extrapolate3(c, xsb + 1, ysb, zsb, dx1, dy1, dz1);
        }
        // contribution (0,1,0)
        double dx2 = dx0 - SQUISH3, dy2 = dy0 - 1 - SQUISH3, dz2 = dz1;
        double attn2 = 2 - dx2 * dx2 - dy2 * dy2 - dz2 * dz2;
        if (attn2 > 0) {
            attn2 *= attn2;
            value += attn2 * attn2 * extrapolate3(c, xsb, ysb + 1, zsb, dx2, dy2, dz2);
        }
        // contribution (0,0,1)
        double dx3 = dx2, dy3 = dy1, dz3 = dz0 - 1 - SQUISH3;
        double attn3 = 2 - dx3 * dx3 - dy3 * dy3 - dz3 * dz3;
        if (attn3 > 0) {
            attn3 *= attn3;
            value += attn3 * attn3 * extrapolate3(c, xsb, ysb, zsb + 1, dx3, dy3, dz3);
        }
    } else if (in_sum >= 2) {  // inside the tetrahedron at (1,1,1)
        uint8_t a_point = 0x06, b_point = 0x05;
        double a_score = xins, b_score = yins;
        if (a_score <= b_score && zins < b_score) {
            b_score = zins; b_point = 0x03;
        } else if (a_score > b_score && zins < a_score) {
            a_score = zins; a_point = 0x03;
        }
        double wins = 3 - in_sum;
        if (wins < a_score || wins < b_score) {  // (1,1,1) is a closest
            uint8_t closest = (b_score < a_score) ? b_point : a_point;
            if (closest & 0x01) {
                xsv_ext0 = xsb + 2; ysv_ext0 = ysb + 1; zsv_ext0 = zsb + 1;
                dx_ext0 = dx0 - 2 - 3 * SQUISH3; dy_ext0 = dy0 - 1 - 3 * SQUISH3; dz_ext0 = dz0 - 1 - 3 * SQUISH3;
                xsv_ext1 = xsb + 1; ysv_ext1 = ysb + 2; zsv_ext1 = zsb;
                // unreachable combination guard; falls through to generic below
                dx_ext1 = dx0 - 1 - 3 * SQUISH3; dy_ext1 = dy0 - 2 - 3 * SQUISH3; dz_ext1 = dz0 - 3 * SQUISH3;
            }
            if (closest == 0x03) {
                xsv_ext0 = xsb + 1; ysv_ext0 = ysb + 1; zsv_ext0 = zsb + 2;
                dx_ext0 = dx0 - 1 - 3 * SQUISH3; dy_ext0 = dy0 - 1 - 3 * SQUISH3; dz_ext0 = dz0 - 2 - 3 * SQUISH3;
            } else if (closest == 0x05) {
                xsv_ext0 = xsb + 1; ysv_ext0 = ysb + 2; zsv_ext0 = zsb + 1;
                dx_ext0 = dx0 - 1 - 3 * SQUISH3; dy_ext0 = dy0 - 2 - 3 * SQUISH3; dz_ext0 = dz0 - 1 - 3 * SQUISH3;
            } else if (closest == 0x06) {
                xsv_ext0 = xsb + 2; ysv_ext0 = ysb + 1; zsv_ext0 = zsb + 1;
                dx_ext0 = dx0 - 2 - 3 * SQUISH3; dy_ext0 = dy0 - 1 - 3 * SQUISH3; dz_ext0 = dz0 - 1 - 3 * SQUISH3;
            }
            xsv_ext1 = xsb + 1; ysv_ext1 = ysb + 1; zsv_ext1 = zsb + 1;
            dx_ext1 = dx0 - 1 - 2 * SQUISH3; dy_ext1 = dy0 - 1 - 2 * SQUISH3; dz_ext1 = dz0 - 1 - 2 * SQUISH3;
        } else {  // (1,1,1) not closest: extra vertices from the two closest faces
            uint8_t closest = (uint8_t)(a_point & b_point);
            if (closest & 0x01) {
                xsv_ext0 = xsb + 1; ysv_ext0 = ysb; zsv_ext0 = zsb;
                dx_ext0 = dx0 - 1 - SQUISH3; dy_ext0 = dy0 - SQUISH3; dz_ext0 = dz0 - SQUISH3;
                xsv_ext1 = xsb + 2; ysv_ext1 = ysb; zsv_ext1 = zsb;
                dx_ext1 = dx0 - 2 - 2 * SQUISH3; dy_ext1 = dy0 - 2 * SQUISH3; dz_ext1 = dz0 - 2 * SQUISH3;
            } else if (closest & 0x02) {
                xsv_ext0 = xsb; ysv_ext0 = ysb + 1; zsv_ext0 = zsb;
                dx_ext0 = dx0 - SQUISH3; dy_ext0 = dy0 - 1 - SQUISH3; dz_ext0 = dz0 - SQUISH3;
                xsv_ext1 = xsb; ysv_ext1 = ysb + 2; zsv_ext1 = zsb;
                dx_ext1 = dx0 - 2 * SQUISH3; dy_ext1 = dy0 - 2 - 2 * SQUISH3; dz_ext1 = dz0 - 2 * SQUISH3;
            } else {
                xsv_ext0 = xsb; ysv_ext0 = ysb; zsv_ext0 = zsb + 1;
                dx_ext0 = dx0 - SQUISH3; dy_ext0 = dy0 - SQUISH3; dz_ext0 = dz0 - 1 - SQUISH3;
                xsv_ext1 = xsb; ysv_ext1 = ysb; zsv_ext1 = zsb + 2;
                dx_ext1 = dx0 - 2 * SQUISH3; dy_ext1 = dy0 - 2 * SQUISH3; dz_ext1 = dz0 - 2 - 2 * SQUISH3;
            }
        }

        // contribution (1,1,0)
        double dx3 = dx0 - 1 - 2 * SQUISH3, dy3 = dy0 - 1 - 2 * SQUISH3, dz3 = dz0 - 2 * SQUISH3;
        double attn3 = 2 - dx3 * dx3 - dy3 * dy3 - dz3 * dz3;
        if (attn3 > 0) {
            attn3 *= attn3;
            value += attn3 * attn3 * extrapolate3(c, xsb + 1, ysb + 1, zsb, dx3, dy3, dz3);
        }
        // contribution (1,0,1)
        double dx2 = dx3, dy2 = dy0 - 2 * SQUISH3, dz2 = dz0 - 1 - 2 * SQUISH3;
        double attn2 = 2 - dx2 * dx2 - dy2 * dy2 - dz2 * dz2;
        if (attn2 > 0) {
            attn2 *= attn2;
            value += attn2 * attn2 * extrapolate3(c, xsb + 1, ysb, zsb + 1, dx2, dy2, dz2);
        }
        // contribution (0,1,1)
        double dx1 = dx0 - 2 * SQUISH3, dy1 = dy3, dz1 = dz2;
        double attn1 = 2 - dx1 * dx1 - dy1 * dy1 - dz1 * dz1;
        if (attn1 > 0) {
            attn1 *= attn1;
            value += attn1 * attn1 * extrapolate3(c, xsb, ysb + 1, zsb + 1, dx1, dy1, dz1);
        }
        // contribution (1,1,1)
        dx0 = dx0 - 1 - 3 * SQUISH3; dy0 = dy0 - 1 - 3 * SQUISH3; dz0 = dz0 - 1 - 3 * SQUISH3;
        double attn0 = 2 - dx0 * dx0 - dy0 * dy0 - dz0 * dz0;
        if (attn0 > 0) {
            attn0 *= attn0;
            value += attn0 * attn0 * extrapolate3(c, xsb + 1, ysb + 1, zsb + 1, dx0, dy0, dz0);
        }
    } else {  // inside the octahedron (rectified 3-simplex) between
        double a_score, b_score;
        uint8_t a_point, b_point;
        bool a_is_further_side, b_is_further_side;

        // decide between (0,0,1) and (1,1,0)
        double p1 = xins + yins;
        if (p1 > 1) { a_score = p1 - 1; a_point = 0x03; a_is_further_side = true; }
        else { a_score = 1 - p1; a_point = 0x04; a_is_further_side = false; }
        // decide between (0,1,0) and (1,0,1)
        double p2 = xins + zins;
        if (p2 > 1) { b_score = p2 - 1; b_point = 0x05; b_is_further_side = true; }
        else { b_score = 1 - p2; b_point = 0x02; b_is_further_side = false; }
        // (1,0,0) vs (0,1,1) may beat either
        double p3 = yins + zins;
        if (p3 > 1) {
            double score = p3 - 1;
            if (a_score <= b_score && a_score < score) { a_score = score; a_point = 0x06; a_is_further_side = true; }
            else if (a_score > b_score && b_score < score) { b_score = score; b_point = 0x06; b_is_further_side = true; }
        } else {
            double score = 1 - p3;
            if (a_score <= b_score && a_score < score) { a_score = score; a_point = 0x01; a_is_further_side = false; }
            else if (a_score > b_score && b_score < score) { b_score = score; b_point = 0x01; b_is_further_side = false; }
        }

        if (a_is_further_side == b_is_further_side) {
            if (a_is_further_side) {  // both on the (1,1,1) side
                xsv_ext0 = xsb + 1; ysv_ext0 = ysb + 1; zsv_ext0 = zsb + 1;
                dx_ext0 = dx0 - 1 - 3 * SQUISH3; dy_ext0 = dy0 - 1 - 3 * SQUISH3; dz_ext0 = dz0 - 1 - 3 * SQUISH3;
                uint8_t closest = (uint8_t)(a_point & b_point);
                if (closest & 0x01) {
                    xsv_ext1 = xsb + 2; ysv_ext1 = ysb; zsv_ext1 = zsb;
                    dx_ext1 = dx0 - 2 - 2 * SQUISH3; dy_ext1 = dy0 - 2 * SQUISH3; dz_ext1 = dz0 - 2 * SQUISH3;
                } else if (closest & 0x02) {
                    xsv_ext1 = xsb; ysv_ext1 = ysb + 2; zsv_ext1 = zsb;
                    dx_ext1 = dx0 - 2 * SQUISH3; dy_ext1 = dy0 - 2 - 2 * SQUISH3; dz_ext1 = dz0 - 2 * SQUISH3;
                } else {
                    xsv_ext1 = xsb; ysv_ext1 = ysb; zsv_ext1 = zsb + 2;
                    dx_ext1 = dx0 - 2 * SQUISH3; dy_ext1 = dy0 - 2 * SQUISH3; dz_ext1 = dz0 - 2 - 2 * SQUISH3;
                }
            } else {  // both on the (0,0,0) side
                xsv_ext0 = xsb; ysv_ext0 = ysb; zsv_ext0 = zsb;
                dx_ext0 = dx0; dy_ext0 = dy0; dz_ext0 = dz0;
                uint8_t closest = (uint8_t)(a_point | b_point);
                if ((closest & 0x01) == 0) {
                    xsv_ext1 = xsb - 1; ysv_ext1 = ysb + 1; zsv_ext1 = zsb + 1;
                    dx_ext1 = dx0 + 1 - SQUISH3; dy_ext1 = dy0 - 1 - SQUISH3; dz_ext1 = dz0 - 1 - SQUISH3;
                } else if ((closest & 0x02) == 0) {
                    xsv_ext1 = xsb + 1; ysv_ext1 = ysb - 1; zsv_ext1 = zsb + 1;
                    dx_ext1 = dx0 - 1 - SQUISH3; dy_ext1 = dy0 + 1 - SQUISH3; dz_ext1 = dz0 - 1 - SQUISH3;
                } else {
                    xsv_ext1 = xsb + 1; ysv_ext1 = ysb + 1; zsv_ext1 = zsb - 1;
                    dx_ext1 = dx0 - 1 - SQUISH3; dy_ext1 = dy0 - 1 - SQUISH3; dz_ext1 = dz0 + 1 - SQUISH3;
                }
            }
        } else {  // one on each side
            uint8_t c1 = a_is_further_side ? a_point : b_point;  // further
            uint8_t c2 = a_is_further_side ? b_point : a_point;  // closer
            if (c1 == 0x03) {
                xsv_ext0 = xsb + 1; ysv_ext0 = ysb + 1; zsv_ext0 = zsb - 1;
                dx_ext0 = dx0 - 1 - SQUISH3; dy_ext0 = dy0 - 1 - SQUISH3; dz_ext0 = dz0 + 1 - SQUISH3;
            } else if (c1 == 0x05) {
                xsv_ext0 = xsb + 1; ysv_ext0 = ysb - 1; zsv_ext0 = zsb + 1;
                dx_ext0 = dx0 - 1 - SQUISH3; dy_ext0 = dy0 + 1 - SQUISH3; dz_ext0 = dz0 - 1 - SQUISH3;
            } else {
                xsv_ext0 = xsb - 1; ysv_ext0 = ysb + 1; zsv_ext0 = zsb + 1;
                dx_ext0 = dx0 + 1 - SQUISH3; dy_ext0 = dy0 - 1 - SQUISH3; dz_ext0 = dz0 - 1 - SQUISH3;
            }
            if (c2 == 0x01) {
                xsv_ext1 = xsb + 1; ysv_ext1 = ysb; zsv_ext1 = zsb;
                dx_ext1 = dx0 - 1 - SQUISH3; dy_ext1 = dy0 - SQUISH3; dz_ext1 = dz0 - SQUISH3;
            } else if (c2 == 0x02) {
                xsv_ext1 = xsb; ysv_ext1 = ysb + 1; zsv_ext1 = zsb;
                dx_ext1 = dx0 - SQUISH3; dy_ext1 = dy0 - 1 - SQUISH3; dz_ext1 = dz0 - SQUISH3;
            } else {
                xsv_ext1 = xsb; ysv_ext1 = ysb; zsv_ext1 = zsb + 1;
                dx_ext1 = dx0 - SQUISH3; dy_ext1 = dy0 - SQUISH3; dz_ext1 = dz0 - 1 - SQUISH3;
            }
        }

        // six contributions of the octahedral region
        double dx1 = dx0 - 1 - SQUISH3, dy1 = dy0 - SQUISH3, dz1 = dz0 - SQUISH3;
        double attn1 = 2 - dx1 * dx1 - dy1 * dy1 - dz1 * dz1;
        if (attn1 > 0) {
            attn1 *= attn1;
            value += attn1 * attn1 * extrapolate3(c, xsb + 1, ysb, zsb, dx1, dy1, dz1);
        }
        double dx2 = dx0 - SQUISH3, dy2 = dy0 - 1 - SQUISH3, dz2 = dz1;
        double attn2 = 2 - dx2 * dx2 - dy2 * dy2 - dz2 * dz2;
        if (attn2 > 0) {
            attn2 *= attn2;
            value += attn2 * attn2 * extrapolate3(c, xsb, ysb + 1, zsb, dx2, dy2, dz2);
        }
        double dx3 = dx2, dy3 = dy1, dz3 = dz0 - 1 - SQUISH3;
        double attn3 = 2 - dx3 * dx3 - dy3 * dy3 - dz3 * dz3;
        if (attn3 > 0) {
            attn3 *= attn3;
            value += attn3 * attn3 * extrapolate3(c, xsb, ysb, zsb + 1, dx3, dy3, dz3);
        }
        double dx4 = dx0 - 1 - 2 * SQUISH3, dy4 = dy0 - 1 - 2 * SQUISH3, dz4 = dz0 - 2 * SQUISH3;
        double attn4 = 2 - dx4 * dx4 - dy4 * dy4 - dz4 * dz4;
        if (attn4 > 0) {
            attn4 *= attn4;
            value += attn4 * attn4 * extrapolate3(c, xsb + 1, ysb + 1, zsb, dx4, dy4, dz4);
        }
        double dx5 = dx4, dy5 = dy0 - 2 * SQUISH3, dz5 = dz0 - 1 - 2 * SQUISH3;
        double attn5 = 2 - dx5 * dx5 - dy5 * dy5 - dz5 * dz5;
        if (attn5 > 0) {
            attn5 *= attn5;
            value += attn5 * attn5 * extrapolate3(c, xsb + 1, ysb, zsb + 1, dx5, dy5, dz5);
        }
        double dx6 = dx0 - 2 * SQUISH3, dy6 = dy4, dz6 = dz5;
        double attn6 = 2 - dx6 * dx6 - dy6 * dy6 - dz6 * dz6;
        if (attn6 > 0) {
            attn6 *= attn6;
            value += attn6 * attn6 * extrapolate3(c, xsb, ysb + 1, zsb + 1, dx6, dy6, dz6);
        }
    }

    // two extra vertices shared by all regions
    double attn_e0 = 2 - dx_ext0 * dx_ext0 - dy_ext0 * dy_ext0 - dz_ext0 * dz_ext0;
    if (attn_e0 > 0) {
        attn_e0 *= attn_e0;
        value += attn_e0 * attn_e0 *
                 extrapolate3(c, xsv_ext0, ysv_ext0, zsv_ext0, dx_ext0, dy_ext0, dz_ext0);
    }
    double attn_e1 = 2 - dx_ext1 * dx_ext1 - dy_ext1 * dy_ext1 - dz_ext1 * dz_ext1;
    if (attn_e1 > 0) {
        attn_e1 *= attn_e1;
        value += attn_e1 * attn_e1 *
                 extrapolate3(c, xsv_ext1, ysv_ext1, zsv_ext1, dx_ext1, dy_ext1, dz_ext1);
    }
    return value / NORM3;
}

}  // namespace

extern "C" {

// Fill out[H*W] with fractal OpenSimplex noise on the z=T plane:
// sum_o persistence^o * noise3(x/(f/2^o), y/(f/2^o), T/(f/2^o)).
// Matches Simplex_CLASS.rand_3d_fixed_T_octaves (reference simplex_noise.py:141-159).
void opensimplex3_fixed_t_grid(int64_t seed, double T, int64_t H, int64_t W,
                               int64_t octaves, double persistence,
                               double frequency, double* out) {
    Ctx ctx;
    init_ctx(&ctx, seed);
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < H; i++) {
        for (int64_t j = 0; j < W; j++) {
            double freq = frequency, amp = 1.0, v = 0.0;
            for (int64_t o = 0; o < octaves; o++) {
                v += amp * noise3(&ctx, (double)j / freq, (double)i / freq, T / freq);
                freq /= 2.0;
                amp *= persistence;
            }
            out[i * W + j] = v;
        }
    }
}

// Batched fixed-T planes: out[n*H*W], one (seed, T) pair per plane.
// Parallelizes ACROSS planes (each plane is small at scoring geometry, so
// the per-plane loop above under-fills the thread pool); seeds are drawn by
// the caller in reference RNG order, so results are bit-identical to n
// sequential opensimplex3_fixed_t_grid calls.
void opensimplex3_fixed_t_grid_batch(const int64_t* seeds, const double* Ts,
                                     int64_t n, int64_t H, int64_t W,
                                     int64_t octaves, double persistence,
                                     double frequency, double* out) {
#pragma omp parallel for schedule(dynamic)
    for (int64_t k = 0; k < n; k++) {
        Ctx ctx;
        init_ctx(&ctx, seeds[k]);
        double* o_k = out + k * H * W;
        for (int64_t i = 0; i < H; i++) {
            for (int64_t j = 0; j < W; j++) {
                double freq = frequency, amp = 1.0, v = 0.0;
                for (int64_t o = 0; o < octaves; o++) {
                    v += amp * noise3(&ctx, (double)j / freq, (double)i / freq,
                                      Ts[k] / freq);
                    freq /= 2.0;
                    amp *= persistence;
                }
                o_k[i * W + j] = v;
            }
        }
    }
}

// Fill out[D*H*W] with 3D fractal noise (rand_3d_octaves parity,
// reference simplex_noise.py:105-121: axes ordered z,y,x -> noise3array(x,y,z)).
void opensimplex3_grid(int64_t seed, int64_t D, int64_t H, int64_t W,
                       int64_t octaves, double persistence, double frequency,
                       double* out) {
    Ctx ctx;
    init_ctx(&ctx, seed);
#pragma omp parallel for schedule(static)
    for (int64_t d = 0; d < D; d++) {
        for (int64_t i = 0; i < H; i++) {
            for (int64_t j = 0; j < W; j++) {
                double freq = frequency, amp = 1.0, v = 0.0;
                for (int64_t o = 0; o < octaves; o++) {
                    v += amp * noise3(&ctx, (double)j / freq, (double)i / freq,
                                      (double)d / freq);
                    freq /= 2.0;
                    amp *= persistence;
                }
                out[(d * H + i) * W + j] = v;
            }
        }
    }
}

// 2D fractal noise (rand_2d_octaves parity, reference simplex_noise.py:123-139).
void opensimplex2_grid(int64_t seed, int64_t H, int64_t W, int64_t octaves,
                       double persistence, double frequency, double* out) {
    Ctx ctx;
    init_ctx(&ctx, seed);
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < H; i++) {
        for (int64_t j = 0; j < W; j++) {
            double freq = frequency, amp = 1.0, v = 0.0;
            for (int64_t o = 0; o < octaves; o++) {
                v += amp * noise2(&ctx, (double)j / freq, (double)i / freq);
                freq /= 2.0;
                amp *= persistence;
            }
            out[i * W + j] = v;
        }
    }
}

// Expose the permutation init for reproducibility tests.
void opensimplex_perm(int64_t seed, int16_t* perm_out, int16_t* grad3_out) {
    Ctx ctx;
    init_ctx(&ctx, seed);
    std::memcpy(perm_out, ctx.perm, sizeof(ctx.perm));
    std::memcpy(grad3_out, ctx.perm_grad3, sizeof(ctx.perm_grad3));
}

}  // extern "C"
