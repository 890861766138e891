// Oriented-box collision core, called through ctypes by
// eval_driving_safety_tpu_torch/safety/collision.py, which builds it with
// g++ -O3 -shared -fPIC at its first use.
//
// The ego trajectory, a sequence of time-stamped boxes, is tested against
// a scenario's static boxes (at every time step) and its dynamic
// obstacles' boxes (at the ego state's time step only): a 2D
// separating-axis test on the two rectangles' four edge normals, in f64,
// with the same expressions in the same order as the JAX package's core
// (eval_driving_safety_tpu/native/collision.cpp), so both libraries built
// with the same flags decide alike.

#include <cmath>
#include <cstdint>

namespace {

struct OBB {
    double cx, cy, c, s, hl, hw;  // center, cos/sin(orient), half length/width
};

inline OBB make_obb(const double* row) {
    // row: cx, cy, orient, length, width
    OBB b;
    b.cx = row[0];
    b.cy = row[1];
    b.c = std::cos(row[2]);
    b.s = std::sin(row[2]);
    b.hl = 0.5 * row[3];
    b.hw = 0.5 * row[4];
    return b;
}

// True where axis (ax, ay) separates the boxes: the distance of their
// centers along it exceeds the sum of their half extents.
inline bool axis_separates(const OBB& a, const OBB& b, double ax, double ay) {
    const double dx = b.cx - a.cx;
    const double dy = b.cy - a.cy;
    const double dist = std::fabs(dx * ax + dy * ay);
    const double ra = a.hl * std::fabs(ax * a.c + ay * a.s)
                    + a.hw * std::fabs(-ax * a.s + ay * a.c);
    const double rb = b.hl * std::fabs(ax * b.c + ay * b.s)
                    + b.hw * std::fabs(-ax * b.s + ay * b.c);
    return dist > ra + rb;
}

inline bool obb_overlap(const OBB& a, const OBB& b) {
    return !(axis_separates(a, b, a.c, a.s)
             || axis_separates(a, b, -a.s, a.c)
             || axis_separates(a, b, b.c, b.s)
             || axis_separates(a, b, -b.s, b.c));
}

}  // namespace

extern "C" {

// One pair. Rows: cx, cy, orient, length, width.
int obb_intersect(const double* a, const double* b) {
    return obb_overlap(make_obb(a), make_obb(b)) ? 1 : 0;
}

// The ego trajectory against a scenario.
//   ego : n_ego x 6 rows (t, cx, cy, orient, length, width)
//   stat: n_stat x 5 rows (cx, cy, orient, length, width)
//   dyn : n_dyn x 6 rows (t, cx, cy, orient, length, width), the states of
//         every dynamic obstacle, matched to ego states by t.
// Returns the 0-based index of the first colliding ego state, or -1.
int trajectory_first_collision(const double* ego, int n_ego,
                               const double* stat, int n_stat,
                               const double* dyn, int n_dyn) {
    for (int i = 0; i < n_ego; ++i) {
        const double t = ego[i * 6];
        const OBB e = make_obb(ego + i * 6 + 1);
        for (int j = 0; j < n_stat; ++j) {
            if (obb_overlap(e, make_obb(stat + j * 5))) return i;
        }
        for (int j = 0; j < n_dyn; ++j) {
            if (dyn[j * 6] == t
                && obb_overlap(e, make_obb(dyn + j * 6 + 1))) return i;
        }
    }
    return -1;
}

}  // extern "C"
