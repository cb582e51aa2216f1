// tessglq — native tesseroid forward engine (Uieda et al. 2016 method).
//
// C++/OpenMP replacement for the reference's numba-JIT adaptive engine
// (reference: gravmag/_tesseroid_numba.py:32-71): per (observation, cell)
// pair, subdivide the tesseroid on an explicit stack until
// distance > ratio * size per axis, then evaluate a 2-point Gauss-Legendre
// quadrature; accumulate the density-free kernel matrix directly.
// Parallelised over observation points (each kernel row is private, no
// synchronisation), replacing the reference's multiprocessing.Pool with
// its double forward pass and >4 GB pickles
// (reference: gravmag/tesseroid.py:156-186, pickle4reducer.py).
//
// The algorithmic constants match the reference exactly: GLQ nodes
// +-1/sqrt(3), minimum sizes 0.1 m horizontal / 1e3 m radial, stack
// depth 100 semantics (we fall back to evaluating an undersized stack
// remainder instead of raising).
//
// A copy of the JAX package's gravinv3dhmc_tpu/runtime/native/tessglq.cpp:
// the dense kernel matrix, the explicit pair subset (the near-field values
// of the device builder) and the two-pass subdivision mask. The code is
// unchanged, so with the same flags its results are the same bit for bit.
//
// Build (gravinv3dhmc_tpu_torch/runtime/tessglq.py does it at first use):
// Build: g++ -O3 -march=native -fopenmp -std=c++17 -shared -fPIC tessglq.cpp -o libtessglq.so

#include <cmath>
#include <cstdint>
#include <cstdio>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr double MEAN_EARTH_RADIUS = 6378137.0;
constexpr double D2R = 0.017453292519943295;  // pi / 180
constexpr double NODE = 0.577350269189625731058868041146;
constexpr int STACK_SIZE = 400;

enum Field {
    F_POT = 0, F_GX = 1, F_GY = 2, F_GZ = 3,
    F_GXX = 4, F_GXY = 5, F_GXZ = 6, F_GYY = 7, F_GYZ = 8, F_GZZ = 9,
};

struct Obs {
    double lon;      // radians
    double sinlat;
    double coslat;
    double radius;   // metres
};

struct Cell {
    double w, e, s, n, top, bottom;  // degrees / metres
};

// one GLQ evaluation of a leaf cell for one observation point
template <int FIELD>
double glq_eval(const Obs &o, const Cell &c) {
    double lonc[2], sinlatc[2], coslatc[2], rc[2];
    const double dlon = D2R * (c.e - c.w);
    const double dlat = D2R * (c.n - c.s);
    const double dr = c.top - c.bottom;
    const double mid_lon = D2R * 0.5 * (c.e + c.w);
    const double mid_lat = D2R * 0.5 * (c.n + c.s);
    const double mid_r = 0.5 * (c.top + c.bottom) + MEAN_EARTH_RADIUS;
    for (int i = 0; i < 2; ++i) {
        const double t = (i == 0) ? -NODE : NODE;
        lonc[i] = 0.5 * dlon * t + mid_lon;
        const double latc = 0.5 * dlat * t + mid_lat;
        sinlatc[i] = sin(latc);
        coslatc[i] = cos(latc);
        rc[i] = 0.5 * dr * t + mid_r;
    }
    const double scale = dlon * dlat * dr * 0.125;
    const double r_sqr = o.radius * o.radius;
    double result = 0.0;
    for (int i = 0; i < 2; ++i) {
        const double coslon = cos(o.lon - lonc[i]);
        const double sinlon = sin(lonc[i] - o.lon);
        for (int j = 0; j < 2; ++j) {
            const double cospsi =
                o.sinlat * sinlatc[j] + o.coslat * coslatc[j] * coslon;
            const double kphi =
                o.coslat * sinlatc[j] - o.sinlat * coslatc[j] * coslon;
            for (int k = 0; k < 2; ++k) {
                const double rck = rc[k];
                const double l_sqr =
                    r_sqr + rck * rck - 2.0 * o.radius * rck * cospsi;
                const double kappa = rck * rck * coslatc[j];
                if (FIELD == F_POT) {
                    result += kappa / sqrt(l_sqr);
                } else if (FIELD == F_GX) {
                    result += kappa * rck * kphi / (l_sqr * sqrt(l_sqr));
                } else if (FIELD == F_GY) {
                    result += kappa * rck * coslatc[j] * sinlon /
                              (l_sqr * sqrt(l_sqr));
                } else if (FIELD == F_GZ) {
                    // sign flip applied after the loop
                    result += kappa * (rck * cospsi - o.radius) /
                              (l_sqr * sqrt(l_sqr));
                } else {
                    const double l5 = l_sqr * l_sqr * sqrt(l_sqr);
                    const double deltax = rck * kphi;
                    const double deltay = rck * coslatc[j] * sinlon;
                    const double deltaz = rck * cospsi - o.radius;
                    if (FIELD == F_GXX)
                        result += kappa * (3.0 * deltax * deltax - l_sqr) / l5;
                    else if (FIELD == F_GXY)
                        result += kappa * 3.0 * deltax * deltay / l5;
                    else if (FIELD == F_GXZ)
                        result += kappa * 3.0 * deltax * deltaz / l5;
                    else if (FIELD == F_GYY)
                        result += kappa * (3.0 * deltay * deltay - l_sqr) / l5;
                    else if (FIELD == F_GYZ)
                        result += kappa * 3.0 * deltay * deltaz / l5;
                    else  // F_GZZ
                        result += kappa * (3.0 * deltaz * deltaz - l_sqr) / l5;
                }
            }
        }
    }
    if (FIELD == F_GZ) result = -result;  // z-down positive
    return result * scale;
}

// distance-vs-size subdivision test (reference:
// gravmag/_tesseroid_numba.py:94-157)
inline void divisions(const Obs &o, const Cell &c, double ratio, int *nlon,
                      int *nlat, int *nr) {
    const double rt = 0.5 * (c.top + c.bottom) + MEAN_EARTH_RADIUS;
    const double lont = D2R * 0.5 * (c.w + c.e);
    const double latt = D2R * 0.5 * (c.s + c.n);
    const double sinlatt = sin(latt);
    const double coslatt = cos(latt);
    const double cospsi =
        o.sinlat * sinlatt + o.coslat * coslatt * cos(o.lon - lont);
    const double distance =
        sqrt(o.radius * o.radius + rt * rt - 2.0 * o.radius * rt * cospsi);
    const double rtop = c.top + MEAN_EARTH_RADIUS;
    double arg1 = sinlatt * sinlatt +
                  coslatt * coslatt * cos(D2R * (c.e - c.w));
    if (arg1 > 1) arg1 = 1;
    if (arg1 < -1) arg1 = -1;
    const double Llon = rtop * acos(arg1);
    double arg2 = sin(D2R * c.n) * sin(D2R * c.s) +
                  cos(D2R * c.n) * cos(D2R * c.s);
    if (arg2 > 1) arg2 = 1;
    if (arg2 < -1) arg2 = -1;
    const double Llat = rtop * acos(arg2);
    const double Lr = c.top - c.bottom;
    *nlon = (distance <= ratio * Llon && Llon > 0.1) ? 2 : 1;
    *nlat = (distance <= ratio * Llat && Llat > 0.1) ? 2 : 1;
    *nr = (distance <= ratio * Lr && Lr > 1e3) ? 2 : 1;
}

template <int FIELD>
double adaptive_cell(const Obs &o, const Cell &root, double ratio) {
    Cell stack[STACK_SIZE];
    int top = 0;
    stack[0] = root;
    double result = 0.0;
    while (top >= 0) {
        Cell c = stack[top--];
        int nlon, nlat, nr;
        divisions(o, c, ratio, &nlon, &nlat, &nr);
        const int ncells = nlon * nlat * nr;
        if (ncells > 1 && top + ncells < STACK_SIZE) {
            const double dlon = (c.e - c.w) / nlon;
            const double dlat = (c.n - c.s) / nlat;
            const double dr = (c.top - c.bottom) / nr;
            for (int i = 0; i < nlon; ++i)
                for (int j = 0; j < nlat; ++j)
                    for (int k = 0; k < nr; ++k) {
                        Cell ch;
                        ch.w = c.w + i * dlon;
                        ch.e = c.w + (i + 1) * dlon;
                        ch.s = c.s + j * dlat;
                        ch.n = c.s + (j + 1) * dlat;
                        ch.bottom = c.bottom + k * dr;
                        ch.top = c.bottom + (k + 1) * dr;
                        stack[++top] = ch;
                    }
        } else {
            // leaf (or stack full: evaluate as-is, accuracy best-effort)
            result += glq_eval<FIELD>(o, c);
        }
    }
    return result;
}

template <int FIELD>
void kernel_matrix(const double *lon_deg, const double *lat_deg,
                   const double *height, int64_t n_obs, const double *cells,
                   int64_t n_cells, double ratio, double *kernel) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 4)
#endif
    for (int64_t l = 0; l < n_obs; ++l) {
        Obs o;
        o.lon = D2R * lon_deg[l];
        const double lat = D2R * lat_deg[l];
        o.sinlat = sin(lat);
        o.coslat = cos(lat);
        o.radius = MEAN_EARTH_RADIUS + height[l];
        double *row = kernel + l * n_cells;
        for (int64_t m = 0; m < n_cells; ++m) {
            Cell c;
            c.w = cells[m * 6 + 0];
            c.e = cells[m * 6 + 1];
            c.s = cells[m * 6 + 2];
            c.n = cells[m * 6 + 3];
            c.top = cells[m * 6 + 4];
            c.bottom = cells[m * 6 + 5];
            row[m] = adaptive_cell<FIELD>(o, c, ratio);
        }
    }
}

template <int FIELD>
void kernel_pairs(const double *lon_deg, const double *lat_deg,
                  const double *height, const int64_t *oi, const int64_t *ci,
                  int64_t n_pairs, const double *cells, double ratio,
                  double *out) {
    // sparse (obs, cell) subset of the full matrix — used by the device
    // kernel builder to evaluate only near-field pairs exactly while the
    // accelerator handles the far field
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 64)
#endif
    for (int64_t p = 0; p < n_pairs; ++p) {
        Obs o;
        const int64_t l = oi[p];
        o.lon = D2R * lon_deg[l];
        const double lat = D2R * lat_deg[l];
        o.sinlat = sin(lat);
        o.coslat = cos(lat);
        o.radius = MEAN_EARTH_RADIUS + height[l];
        const double *cb = cells + ci[p] * 6;
        Cell c;
        c.w = cb[0];
        c.e = cb[1];
        c.s = cb[2];
        c.n = cb[3];
        c.top = cb[4];
        c.bottom = cb[5];
        out[p] = adaptive_cell<FIELD>(o, c, ratio);
    }
}

// ---------------------------------------------------------------------
// subdivision mask: which (obs, cell) ROOT pairs would the adaptive
// engine split (distance <= ratio * size on any axis)? Two-pass: count
// per observation, then fill at prefix-sum offsets — no synchronisation.
// The per-cell terms (lont, sinlatt, coslatt, rt, thr=max (ratio*L)^2)
// are precomputed by the caller (ops/tesseroid.py _mask_cell_terms) so
// this test matches the python host path bit-for-bit in f64.
void subdiv_mask_count(const double *lon_r, const double *sinlat,
                       const double *coslat, const double *radius,
                       int64_t n_obs, const double *lont,
                       const double *sinlatt, const double *coslatt,
                       const double *rt, const double *thr, int64_t n_cells,
                       int64_t *counts) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 8)
#endif
    for (int64_t l = 0; l < n_obs; ++l) {
        const double lo = lon_r[l], sl = sinlat[l], cl = coslat[l];
        const double r = radius[l], r2 = r * r;
        int64_t cnt = 0;
        for (int64_t m = 0; m < n_cells; ++m) {
            const double cospsi =
                sl * sinlatt[m] + cl * coslatt[m] * cos(lo - lont[m]);
            const double d2 = r2 + rt[m] * rt[m] - 2.0 * r * rt[m] * cospsi;
            cnt += (d2 <= thr[m]);
        }
        counts[l] = cnt;
    }
}

void subdiv_mask_fill(const double *lon_r, const double *sinlat,
                      const double *coslat, const double *radius,
                      int64_t n_obs, const double *lont,
                      const double *sinlatt, const double *coslatt,
                      const double *rt, const double *thr, int64_t n_cells,
                      const int64_t *offsets, int32_t *oi, int32_t *ci) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 8)
#endif
    for (int64_t l = 0; l < n_obs; ++l) {
        const double lo = lon_r[l], sl = sinlat[l], cl = coslat[l];
        const double r = radius[l], r2 = r * r;
        int64_t k = offsets[l];
        for (int64_t m = 0; m < n_cells; ++m) {
            const double cospsi =
                sl * sinlatt[m] + cl * coslatt[m] * cos(lo - lont[m]);
            const double d2 = r2 + rt[m] * rt[m] - 2.0 * r * rt[m] * cospsi;
            if (d2 <= thr[m]) {
                oi[k] = static_cast<int32_t>(l);
                ci[k] = static_cast<int32_t>(m);
                ++k;
            }
        }
    }
}

}  // namespace

extern "C" {

void tessglq_subdiv_count(const double *lon_r, const double *sinlat,
                          const double *coslat, const double *radius,
                          int64_t n_obs, const double *lont,
                          const double *sinlatt, const double *coslatt,
                          const double *rt, const double *thr,
                          int64_t n_cells, int64_t *counts) {
    subdiv_mask_count(lon_r, sinlat, coslat, radius, n_obs, lont, sinlatt,
                      coslatt, rt, thr, n_cells, counts);
}

void tessglq_subdiv_fill(const double *lon_r, const double *sinlat,
                         const double *coslat, const double *radius,
                         int64_t n_obs, const double *lont,
                         const double *sinlatt, const double *coslatt,
                         const double *rt, const double *thr,
                         int64_t n_cells, const int64_t *offsets,
                         int32_t *oi, int32_t *ci) {
    subdiv_mask_fill(lon_r, sinlat, coslat, radius, n_obs, lont, sinlatt,
                     coslatt, rt, thr, n_cells, offsets, oi, ci);
}

void tessglq_kernel_pairs(int field, const double *lon, const double *lat,
                          const double *height, const int64_t *oi,
                          const int64_t *ci, int64_t n_pairs,
                          const double *cells, double ratio, double *out) {
    switch (field) {
        case F_POT: kernel_pairs<F_POT>(lon, lat, height, oi, ci, n_pairs, cells, ratio, out); break;
        case F_GX:  kernel_pairs<F_GX>(lon, lat, height, oi, ci, n_pairs, cells, ratio, out); break;
        case F_GY:  kernel_pairs<F_GY>(lon, lat, height, oi, ci, n_pairs, cells, ratio, out); break;
        case F_GZ:  kernel_pairs<F_GZ>(lon, lat, height, oi, ci, n_pairs, cells, ratio, out); break;
        case F_GXX: kernel_pairs<F_GXX>(lon, lat, height, oi, ci, n_pairs, cells, ratio, out); break;
        case F_GXY: kernel_pairs<F_GXY>(lon, lat, height, oi, ci, n_pairs, cells, ratio, out); break;
        case F_GXZ: kernel_pairs<F_GXZ>(lon, lat, height, oi, ci, n_pairs, cells, ratio, out); break;
        case F_GYY: kernel_pairs<F_GYY>(lon, lat, height, oi, ci, n_pairs, cells, ratio, out); break;
        case F_GYZ: kernel_pairs<F_GYZ>(lon, lat, height, oi, ci, n_pairs, cells, ratio, out); break;
        case F_GZZ: kernel_pairs<F_GZZ>(lon, lat, height, oi, ci, n_pairs, cells, ratio, out); break;
        default: break;
    }
}

// field ids match the Field enum above
void tessglq_kernel_matrix(int field, const double *lon, const double *lat,
                           const double *height, int64_t n_obs,
                           const double *cells, int64_t n_cells, double ratio,
                           double *kernel_out) {
    switch (field) {
        case F_POT: kernel_matrix<F_POT>(lon, lat, height, n_obs, cells, n_cells, ratio, kernel_out); break;
        case F_GX:  kernel_matrix<F_GX>(lon, lat, height, n_obs, cells, n_cells, ratio, kernel_out); break;
        case F_GY:  kernel_matrix<F_GY>(lon, lat, height, n_obs, cells, n_cells, ratio, kernel_out); break;
        case F_GZ:  kernel_matrix<F_GZ>(lon, lat, height, n_obs, cells, n_cells, ratio, kernel_out); break;
        case F_GXX: kernel_matrix<F_GXX>(lon, lat, height, n_obs, cells, n_cells, ratio, kernel_out); break;
        case F_GXY: kernel_matrix<F_GXY>(lon, lat, height, n_obs, cells, n_cells, ratio, kernel_out); break;
        case F_GXZ: kernel_matrix<F_GXZ>(lon, lat, height, n_obs, cells, n_cells, ratio, kernel_out); break;
        case F_GYY: kernel_matrix<F_GYY>(lon, lat, height, n_obs, cells, n_cells, ratio, kernel_out); break;
        case F_GYZ: kernel_matrix<F_GYZ>(lon, lat, height, n_obs, cells, n_cells, ratio, kernel_out); break;
        case F_GZZ: kernel_matrix<F_GZZ>(lon, lat, height, n_obs, cells, n_cells, ratio, kernel_out); break;
        default: break;
    }
}

int tessglq_num_threads() {
#ifdef _OPENMP
    return omp_get_max_threads();
#else
    return 1;
#endif
}

}  // extern "C"
