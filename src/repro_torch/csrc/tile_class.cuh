// Exact classes of a triangle on a box of users, for Hopper, sm_90a.
//
// Shared by the dense ray-cast kernel (raycast.cu: a tile of Morton-ordered
// users) and the cell-bucketed grid kernel (grid_raycast.cu: a block of
// Morton-ordered users of one grid cell).  Given the bounding box of a
// group of users, a triangle (three edge functions e_i(x, y) = a x + b y + c)
// falls into one of three classes:
//   SKIP  some edge is below -delta on the whole box: no user is inside;
//   FULL  every edge is at or above +delta on the whole box: every user is
//         inside, so the triangle adds 1 to every user with no test;
//   TEST  anything else: each user needs its own test.
// The degenerate padding rows (a = b = 0, c = -1) are always SKIP.
//
// Why the classes are exact (delta).  Let u = 2^-24.  For a user (x, y)
// the kernels compute r = fl(fl(fl(x a) + fl(y b)) + c) with one rounding
// per operation.  fl(s + c) of two floats has the sign of s + c (an exact
// sum of two floats that is not 0 is at least 2^-149 in magnitude, so it
// never rounds to 0), so r >= 0 iff s + c >= 0 with s = fl(fl(x a) + fl(y b)).
// Each product is off by at most u |x a| + 2^-150 (the second term for a
// result among the subnormals), and the sum by u |fl(x a) + fl(y b)|, so
//   |s - (x a + y b)| <= (2u + u^2)(|a| |x| + |b| |y|) + 2^-148.
// Hence with e = x a + y b + c exact: e >= d(x, y) gives r >= 0, and
// e < -d(x, y) gives r < 0, where d(x, y) is that bound.  Over the box,
// |x| <= X = max(|x_min|, |x_max|) and |y| <= Y likewise, and e is linear,
// so e_min and e_max are its values at two corners.  They are evaluated
// in float64: the products of two floats are exact there, and the two
// sums are off by at most 2^-52 ((|a| X + |b| Y) + |c|).  So with
//   delta = ((|a| X + |b| Y) + |c|) * 2^-22 + 2^-126   (2^-22 = 4u)
// an edge with e_max < -delta is negative at every user of the box, and
// one with e_min >= delta is non-negative at every user: delta exceeds
// d + the float64 error by a wide margin.  If (|a| X + |b| Y) + |c|
// reaches 2^126 a float32 term may overflow, and the edge decides
// neither class; NaNs fail every comparison and so land in TEST.  A caller
// that tests every TEST triangle per user in the float32 order above, and
// adds the FULL ones, gets counts bit-identical to testing every triangle.
// The plain twin of this classifier is repro_torch/kernels/ref.py
// raycast_tile_classes_ref (same order, same delta).

#pragma once

namespace tile_class {

constexpr int kSkip = 0, kFull = 1, kTest = 2;

__device__ __forceinline__ double affine64(double x, double y, double a, double b, double c) {
  return __dadd_rn(__dadd_rn(__dmul_rn(x, a), __dmul_rn(y, b)), c);
}

// The class of one triangle (coefficients e[3 * edge + {a, b, c}]) on the
// box [x_lo, x_hi] x [y_lo, y_hi] whose largest |x|, |y| are X, Y.
__device__ __forceinline__ int classify(const float* e, double x_lo, double y_lo,
                                        double x_hi, double y_hi, double X, double Y) {
  bool full = true;
  for (int i = 0; i < 3; ++i) {
    const double a = e[3 * i], b = e[3 * i + 1], c = e[3 * i + 2];
    const bool pa = a >= 0.0, pb = b >= 0.0;
    const double e_min = affine64(pa ? x_lo : x_hi, pb ? y_lo : y_hi, a, b, c);
    const double e_max = affine64(pa ? x_hi : x_lo, pb ? y_hi : y_lo, a, b, c);
    const double mag = affine64(X, Y, fabs(a), fabs(b), fabs(c));
    const double delta = __dadd_rn(__dmul_rn(mag, 0x1p-22), 0x1p-126);
    const bool ok = mag < 0x1p126;
    if (ok && e_max < -delta) return kSkip;
    full = full && ok && e_min >= delta;
  }
  return full ? kFull : kTest;
}

}  // namespace tile_class
