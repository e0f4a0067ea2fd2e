// Host-side data IO of the PyTorch port: batched reads of per-scene .bin
// point clouds with random subsampling and padding into the fixed-shape
// batch layout, driven from Python through ctypes
// (cagroup3d_tpu_torch/datasets/native_io.py).
//
// The port's own copy of csrc/dataio.cpp (the JAX package's), with the
// same functions and semantics.  It is built at first use by
// cagroup3d_tpu_torch/ops/build.load_host into .kernel_build/ (without
// -fopenmp: the batch loop then runs in one thread; every scene draws from
// its own generator, so the result is the same).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <random>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Read a float32 .bin file with `cols` columns; returns number of rows
// read (<= cap), or -1 on error.  Rows beyond `cap` are dropped.
long load_bin_f32(const char* path, float* out, long cap, long cols) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    long want = cap * cols;
    long got = (long)std::fread(out, sizeof(float), want, f);
    // drain to learn the true size? not needed: we only keep cap rows
    std::fclose(f);
    return got / cols;
}

// Read an int64 .bin mask into int32 out; returns rows read or -1.
long load_bin_i64_as_i32(const char* path, int32_t* out, long cap) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    const long CHUNK = 1 << 16;
    int64_t buf[1 << 16];
    long total = 0;
    while (total < cap) {
        long want = cap - total < CHUNK ? cap - total : CHUNK;
        long got = (long)std::fread(buf, sizeof(int64_t), want, f);
        if (got <= 0) break;
        for (long i = 0; i < got; ++i) out[total + i] = (int32_t)buf[i];
        total += got;
    }
    std::fclose(f);
    return total;
}

// Fill a padded batch: for each of B scenes, read points/masks, randomly
// subsample to at most point_cap points (without replacement when the
// scene is larger; mimics indoor_point_sample, augmentor_utils.py:746),
// write validity.  paths: B null-terminated strings, each maybe with
// companion instance/semantic mask paths (nullptr entries to skip).
// Returns number of scenes successfully read.
long load_batch(const char** point_paths, const char** ins_paths,
                const char** sem_paths, long B, long point_cap,
                float* points_out /* [B, point_cap, 6] */,
                uint8_t* valid_out /* [B, point_cap] */,
                int32_t* ins_out /* [B, point_cap] or nullptr */,
                int32_t* sem_out /* [B, point_cap] or nullptr */,
                uint64_t seed) {
    long ok = 0;
#pragma omp parallel for schedule(dynamic) reduction(+ : ok)
    for (long b = 0; b < B; ++b) {
        float* pts = points_out + b * point_cap * 6;
        uint8_t* val = valid_out + b * point_cap;
        std::memset(val, 0, point_cap);
        // read up to 4x cap rows to subsample from (bounded scratch)
        long scratch_rows = point_cap * 4;
        float* scratch = (float*)std::malloc(scratch_rows * 6 * sizeof(float));
        if (!scratch) continue;
        long n = load_bin_f32(point_paths[b], scratch, scratch_rows, 6);
        if (n <= 0) { std::free(scratch); continue; }

        int32_t* ins_scratch = nullptr;
        int32_t* sem_scratch = nullptr;
        if (ins_paths && ins_paths[b] && ins_out) {
            ins_scratch = (int32_t*)std::malloc(scratch_rows * 4);
            load_bin_i64_as_i32(ins_paths[b], ins_scratch, n);
        }
        if (sem_paths && sem_paths[b] && sem_out) {
            sem_scratch = (int32_t*)std::malloc(scratch_rows * 4);
            load_bin_i64_as_i32(sem_paths[b], sem_scratch, n);
        }

        std::mt19937_64 rng(seed + (uint64_t)b * 0x9E3779B97F4A7C15ull);
        long keep = n < point_cap ? n : point_cap;
        if (n <= point_cap) {
            std::memcpy(pts, scratch, n * 6 * sizeof(float));
            if (ins_scratch) std::memcpy(ins_out + b * point_cap,
                                         ins_scratch, n * 4);
            if (sem_scratch) std::memcpy(sem_out + b * point_cap,
                                         sem_scratch, n * 4);
        } else {
            // partial Fisher-Yates: choose point_cap of n without
            // replacement
            int32_t* idx = (int32_t*)std::malloc(n * 4);
            for (long i = 0; i < n; ++i) idx[i] = (int32_t)i;
            for (long i = 0; i < point_cap; ++i) {
                long j = i + (long)(rng() % (uint64_t)(n - i));
                int32_t t = idx[i]; idx[i] = idx[j]; idx[j] = t;
            }
            for (long i = 0; i < point_cap; ++i) {
                std::memcpy(pts + i * 6, scratch + (long)idx[i] * 6,
                            6 * sizeof(float));
                if (ins_scratch)
                    ins_out[b * point_cap + i] = ins_scratch[idx[i]];
                if (sem_scratch)
                    sem_out[b * point_cap + i] = sem_scratch[idx[i]];
            }
            std::free(idx);
        }
        std::memset(val, 1, keep);
        std::free(scratch);
        if (ins_scratch) std::free(ins_scratch);
        if (sem_scratch) std::free(sem_scratch);
        ok += 1;
    }
    return ok;
}

}  // extern "C"
