// gravsink — native runtime for sample streaming and text-matrix IO.
//
// TPU-native replacement for the runtime pieces the reference implements
// ad hoc in Python: the per-accept append of samples to model.dat /
// misfit.dat (reference: inversion/hmc.py:241-249) becomes a lock-free-ish
// double-buffered background writer so the device sampling loop never
// blocks on disk, and the large whitespace text matrices the plot scripts
// reload (reference: example/uniformgrid/plot_uniform.py:47-54) parse at
// memory bandwidth instead of np.loadtxt speed.
//
// Exposed as a plain C ABI consumed from Python via ctypes (no pybind11).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC gravsink.cpp -o libgravsink.so -lpthread

#include <atomic>
#include <cinttypes>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <sys/stat.h>
#include <sys/types.h>

namespace {

// %.8f formatting without the printf locale machinery in the hot loop.
// Values in these files are densities (g/cm^3) and misfit magnitudes:
// plain snprintf is fast enough per element, so keep it simple and exact.
void format_row(std::string &out, const double *vals, int64_t n) {
    char buf[32];
    for (int64_t i = 0; i < n; ++i) {
        int len = snprintf(buf, sizeof(buf), i + 1 == n ? "%.8f" : "%.8f ",
                           vals[i]);
        out.append(buf, len);
    }
    out.push_back('\n');
}

struct Sink {
    FILE *model_f = nullptr;
    FILE *misfit_f = nullptr;
    std::thread worker;
    std::mutex mu;
    std::condition_variable cv;
    std::deque<std::pair<std::string, std::string>> queue;  // (model, misfit)
    bool closing = false;

    void run() {
        for (;;) {
            std::deque<std::pair<std::string, std::string>> batch;
            {
                std::unique_lock<std::mutex> lk(mu);
                cv.wait(lk, [&] { return closing || !queue.empty(); });
                if (queue.empty() && closing) break;
                batch.swap(queue);
            }
            for (auto &item : batch) {
                fwrite(item.first.data(), 1, item.first.size(), model_f);
                fwrite(item.second.data(), 1, item.second.size(), misfit_f);
            }
            fflush(model_f);
            fflush(misfit_f);
        }
    }
};

}  // namespace

extern "C" {

// Create a sink writing <folder>/model.dat and <folder>/misfit.dat
// (truncating any existing files, like the reference's startup cleanup).
void *gravsink_open(const char *folder) {
    std::string dir(folder);
    ::mkdir(dir.c_str(), 0777);  // best-effort; EEXIST is fine
    auto *s = new Sink();
    s->model_f = fopen((dir + "/model.dat").c_str(), "w");
    s->misfit_f = fopen((dir + "/misfit.dat").c_str(), "w");
    if (!s->model_f || !s->misfit_f) {
        if (s->model_f) fclose(s->model_f);
        if (s->misfit_f) fclose(s->misfit_f);
        delete s;
        return nullptr;
    }
    s->worker = std::thread([s] { s->run(); });
    return s;
}

// Enqueue one accepted sample; returns immediately.
void gravsink_append(void *handle, const double *model, int64_t m,
                     const double *misfit, int64_t k) {
    auto *s = static_cast<Sink *>(handle);
    std::string mrow, krow;
    mrow.reserve(static_cast<size_t>(m) * 12);
    format_row(mrow, model, m);
    format_row(krow, misfit, k);
    {
        std::lock_guard<std::mutex> lk(s->mu);
        s->queue.emplace_back(std::move(mrow), std::move(krow));
    }
    s->cv.notify_one();
}

// Block until everything queued so far is on disk.
void gravsink_flush(void *handle) {
    auto *s = static_cast<Sink *>(handle);
    for (;;) {
        {
            std::lock_guard<std::mutex> lk(s->mu);
            if (s->queue.empty()) break;
        }
        std::this_thread::yield();
    }
    fflush(s->model_f);
    fflush(s->misfit_f);
}

void gravsink_close(void *handle) {
    auto *s = static_cast<Sink *>(handle);
    {
        std::lock_guard<std::mutex> lk(s->mu);
        s->closing = true;
    }
    s->cv.notify_one();
    s->worker.join();
    fclose(s->model_f);
    fclose(s->misfit_f);
    delete s;
}

// ---------------------------------------------------------------------
// Fast whitespace-float matrix reader (np.loadtxt replacement for the
// posterior-statistics pass over multi-GB model.dat files).
// Two-phase API: first call with out=nullptr to get counts, then with a
// buffer of rows*cols doubles.
// ---------------------------------------------------------------------

int64_t gravsink_count_matrix(const char *path, int64_t *rows, int64_t *cols) {
    FILE *f = fopen(path, "rb");
    if (!f) return -1;
    std::string line;
    char buf[1 << 16];
    int64_t r = 0, c = -1;
    std::string pending;
    while (size_t got = fread(buf, 1, sizeof(buf), f)) {
        pending.append(buf, got);
        size_t pos = 0, nl;
        while ((nl = pending.find('\n', pos)) != std::string::npos) {
            if (nl > pos) {
                if (c < 0) {
                    // count fields in the first line
                    int64_t fields = 0;
                    bool in = false;
                    for (size_t i = pos; i < nl; ++i) {
                        bool ws = pending[i] == ' ' || pending[i] == '\t' ||
                                  pending[i] == '\r';
                        if (!ws && !in) { ++fields; in = true; }
                        if (ws) in = false;
                    }
                    c = fields;
                }
                ++r;
            }
            pos = nl + 1;
        }
        pending.erase(0, pos);
    }
    if (!pending.empty()) ++r;
    fclose(f);
    *rows = r;
    *cols = c < 0 ? 0 : c;
    return 0;
}

int64_t gravsink_read_matrix(const char *path, double *out, int64_t rows,
                             int64_t cols) {
    FILE *f = fopen(path, "rb");
    if (!f) return -1;
    // read whole file (posterior files are tens of MB to a few GB; stream
    // in chunks to bound memory)
    const size_t CHUNK = 1 << 22;
    std::string pending;
    std::vector<char> buf(CHUNK);
    int64_t n = 0, total = rows * cols;
    while (size_t got = fread(buf.data(), 1, CHUNK, f)) {
        pending.append(buf.data(), got);
        // keep a possibly split trailing token
        size_t keep = pending.find_last_of(" \t\n\r");
        if (keep == std::string::npos) continue;
        // end this pass at that separator: strtod skips whitespace, so
        // from the last complete token it would read the split token's
        // first part past `end`, and the kept rest would count again
        // (every value after a split 4 MiB boundary one place late)
        pending[keep] = '\0';
        const char *p = pending.c_str();
        const char *end = p + keep + 1;
        while (p < end && n < total) {
            char *next;
            double v = strtod(p, &next);
            if (next == p) { ++p; continue; }
            out[n++] = v;
            p = next;
        }
        pending.erase(0, keep + 1);
    }
    if (!pending.empty() && n < total) {
        char *next;
        double v = strtod(pending.c_str(), &next);
        if (next != pending.c_str()) out[n++] = v;
    }
    fclose(f);
    return n;
}

}  // extern "C"
