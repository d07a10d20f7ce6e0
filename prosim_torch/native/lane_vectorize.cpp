// Native lane vectorization: the hot loop of the host-side data engine.
//
// Replaces the Python per-lane loop of prosim_torch/data/formatter.py
// (`vectorize_lanes_plain`, its plain version; reference semantics:
// prosim/dataset/data_utils.py:155-252): for every polyline part (lane center / left edge / right edge) near the scene
// center -> subsample, rotate into the scene frame, clip to the square crop
// range, and chunk into fixed-width segment-vector blocks
// [x0, y0, x1, y1, type, tls].
//
// Exposed as a plain C ABI for ctypes (no Python headers needed):
//   int vectorize_lanes(pts, n_pts, offsets, n_parts, types, tls, rates,
//                       cx, cy, ch, range, max_lane_pts, out, max_chunks)
// Returns the number of chunks written (or -needed if out is too small).
//
// Built by prosim_torch/native/__init__.py: g++ -O3 -ffp-contract=off
// -shared -fPIC (no fused multiply-adds: the plain version's rounding, bit
// for bit).

#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

int vectorize_lanes(
    const double* pts,        // [n_pts, 2] world xy, all parts concatenated
    int64_t n_pts,
    const int64_t* offsets,   // [n_parts + 1] start offset of each part
    int64_t n_parts,
    const float* types,       // [n_parts] lane type (1 center / 2 left / 3 right)
    const float* tls,         // [n_parts] traffic-light status
    const int64_t* rates,     // [n_parts] subsample rate
    double cx, double cy, double ch,
    double map_range,
    int64_t max_lane_pts,     // points per chunk (vectors per chunk = max_lane_pts-1)
    float* out,               // [max_chunks, max_lane_pts-1, 6], zero-filled by caller
    int64_t max_chunks
) {
    const double c = std::cos(-ch), s = std::sin(-ch);
    const int64_t vec_w = max_lane_pts - 1;
    int64_t chunk_count = 0;

    std::vector<double> fx, fy;
    fx.reserve(256);
    fy.reserve(256);

    for (int64_t p = 0; p < n_parts; ++p) {
        const int64_t lo = offsets[p], hi = offsets[p + 1];
        const int64_t rate = rates[p] > 0 ? rates[p] : 1;
        const int64_t n_raw = hi - lo;
        if (n_raw < 2) continue;

        // subsample -> rotate into scene frame -> range filter
        fx.clear();
        fy.clear();
        const int64_t step = (n_raw > rate) ? rate : 1;
        for (int64_t i = lo; i < hi; i += step) {
            const double dx = pts[2 * i] - cx;
            const double dy = pts[2 * i + 1] - cy;
            const double x = dx * c - dy * s;
            const double y = dy * c + dx * s;
            if (std::fabs(x) < map_range && std::fabs(y) < map_range) {
                fx.push_back(x);
                fy.push_back(y);
            }
        }
        const int64_t n = (int64_t)fx.size();
        if (n < 2) continue;

        // chunk boundaries: 0, max_lane_pts, 2*max_lane_pts, ..., n
        for (int64_t b = 0; b < n - 1; b += max_lane_pts) {
            const int64_t e = (b + max_lane_pts < n) ? b + max_lane_pts : n;
            const int64_t v_len = e - b - 1;
            if (v_len < 1) continue;
            if (chunk_count >= max_chunks) return -(int)(chunk_count + 1);
            float* row = out + chunk_count * vec_w * 6;
            for (int64_t v = 0; v < v_len; ++v) {
                row[v * 6 + 0] = (float)fx[b + v];
                row[v * 6 + 1] = (float)fy[b + v];
                row[v * 6 + 2] = (float)fx[b + v + 1];
                row[v * 6 + 3] = (float)fy[b + v + 1];
                row[v * 6 + 4] = types[p];
                row[v * 6 + 5] = tls[p];
            }
            ++chunk_count;
        }
    }
    return (int)chunk_count;
}

}  // extern "C"
