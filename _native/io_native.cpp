// Native I/O library for gmrm_tpu.
//
// Native equivalent of the reference's C++ MPI-IO data path
// (/root/reference/src/bayes.cpp:867-900 genotype load,
//  /root/reference/src/utilities.hpp:29-81 chunked collective reads,
//  /root/reference/src/phenotype.cpp:587-673 .phen parsing):
// multithreaded pread of .bed marker slices into caller-provided buffers
// and a fast PLINK .phen parser.  Exposed through a C ABI consumed via
// ctypes (gmrm_tpu/io/native.py); everything degrades to numpy when this
// library is not built.
//
// Build: make -C _native   (or gmrm_tpu.io.native builds lazily never —
// explicit build keeps the Python path dependency-free).

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <string>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

// pread the whole range [off, off+len) handling short reads.
bool pread_all(int fd, unsigned char* dst, long long off, long long len) {
    long long done = 0;
    while (done < len) {
        ssize_t got = ::pread(fd, dst + done, static_cast<size_t>(len - done),
                              static_cast<off_t>(off + done));
        if (got <= 0) return false;
        done += got;
    }
    return true;
}

}  // namespace

extern "C" {

// Read nbytes at offset from path into buf using n_threads parallel
// preads (0 = auto).  Returns bytes read, or -errno on failure.
long long gmrm_read_block(const char* path, long long offset,
                          long long nbytes, void* buf, int n_threads) {
    int fd = ::open(path, O_RDONLY);
    if (fd < 0) return -static_cast<long long>(errno);

    if (n_threads <= 0) {
        unsigned hw = std::thread::hardware_concurrency();
        n_threads = hw ? static_cast<int>(hw) : 4;
        if (n_threads > 16) n_threads = 16;
    }
    // Small reads: single thread avoids spawn overhead.
    const long long kMinPerThread = 8ll << 20;
    long long want = (nbytes + kMinPerThread - 1) / kMinPerThread;
    if (want < n_threads) n_threads = static_cast<int>(want ? want : 1);

    auto* dst = static_cast<unsigned char*>(buf);
    bool ok = true;
    if (n_threads <= 1) {
        ok = pread_all(fd, dst, offset, nbytes);
    } else {
        std::vector<std::thread> workers;
        std::vector<char> results(static_cast<size_t>(n_threads), 1);
        long long chunk = (nbytes + n_threads - 1) / n_threads;
        for (int t = 0; t < n_threads; ++t) {
            long long begin = static_cast<long long>(t) * chunk;
            long long end = begin + chunk < nbytes ? begin + chunk : nbytes;
            if (begin >= end) { results[t] = 1; continue; }
            workers.emplace_back([=, &results] {
                results[t] = pread_all(fd, dst + begin, offset + begin,
                                       end - begin) ? 1 : 0;
            });
        }
        for (auto& w : workers) w.join();
        for (char r : results) ok = ok && (r != 0);
    }
    ::close(fd);
    return ok ? nbytes : -static_cast<long long>(EIO);
}

// Parse a PLINK .phen file ("FID IID value" per line, value may be NA).
// Writes values[i] (NA -> unspecified) and isna[i] in {0,1}; returns the
// number of individuals parsed, or -1 on open failure, -2 on overflow of
// n_max, -3 on a malformed line.
long long gmrm_parse_phen(const char* path, long long n_max,
                          double* values, unsigned char* isna) {
    FILE* fh = ::fopen(path, "rb");
    if (!fh) return -1;
    // Slurp the file; .phen files are small (tens of MB at biobank scale).
    ::fseek(fh, 0, SEEK_END);
    long size = ::ftell(fh);
    ::fseek(fh, 0, SEEK_SET);
    std::string data(static_cast<size_t>(size), '\0');
    if (size > 0 && ::fread(&data[0], 1, static_cast<size_t>(size), fh) !=
                        static_cast<size_t>(size)) {
        ::fclose(fh);
        return -1;
    }
    ::fclose(fh);

    long long n = 0;
    const char* p = data.c_str();
    const char* end = p + data.size();
    while (p < end) {
        // Skip leading whitespace / blank lines.
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' ||
                           *p == '\n'))
            ++p;
        if (p >= end) break;
        // Third whitespace-separated token on the line is the value.
        const char* tok = p;
        int field = 0;
        const char* val = nullptr;
        while (p < end && *p != '\n') {
            if (*p == ' ' || *p == '\t') {
                ++field;
                ++p;
                while (p < end && (*p == ' ' || *p == '\t')) ++p;
                if (field == 2) val = p;
            } else {
                ++p;
            }
        }
        if (!val) return -3;
        if (n >= n_max) return -2;
        if (val[0] == 'N' && val[1] == 'A' &&
            (val + 2 >= end || val[2] == '\n' || val[2] == '\r' ||
             val[2] == ' ' || val[2] == '\t')) {
            isna[n] = 1;
            values[n] = 0.0;
        } else {
            char* conv_end = nullptr;
            values[n] = ::strtod(val, &conv_end);
            if (conv_end == val) return -3;
            // The whole token must convert (strtod prefix-parses "1.5x");
            // the numpy fallback rejects such lines and the two paths
            // must agree byte-for-byte on what is malformed.
            if (conv_end < end && *conv_end != ' ' && *conv_end != '\t' &&
                *conv_end != '\r' && *conv_end != '\n' && *conv_end != '\0')
                return -3;
            isna[n] = 0;
        }
        ++n;
        (void)tok;
    }
    return n;
}

}  // extern "C"
