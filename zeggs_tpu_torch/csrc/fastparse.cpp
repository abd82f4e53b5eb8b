// Fast whitespace-delimited float matrix parser for BVH motion data.
#include <cstdio>
//
// The data pipeline parses 67 clips x 2 time-stretches of ~8k-frame BVH
// motion blocks (~3.5M floats per clip). NumPy's loadtxt tokenizes per
// line through Python; this parser is a single strtof sweep over the
// buffer (~100x less overhead) exposed through a C ABI for ctypes.
//
// Built on first use with the host C++ compiler by zeggs_tpu_torch/io/native.py
// (into build/zeggs_tpu_torch/); host code, not a CUDA kernel.

#include <cstdlib>
#include <cstring>
#include <cctype>

extern "C" {

// Parse up to `max_count` floats from text[0:len) into out.
// Returns the number of floats parsed.
long parse_floats(const char* text, long len, float* out, long max_count) {
    const char* p = text;
    const char* end = text + len;
    long n = 0;
    while (p < end && n < max_count) {
        // skip non-numeric separators
        while (p < end && std::isspace((unsigned char)*p)) ++p;
        if (p >= end) break;
        char* next = nullptr;
        float v = strtof(p, &next);
        if (next == p) { ++p; continue; }  // unparsable char: skip
        out[n++] = v;
        p = next;
    }
    return n;
}

// Count whitespace-separated tokens in the first line (for column count).
long count_first_row(const char* text, long len) {
    const char* p = text;
    const char* end = text + len;
    long n = 0;
    bool in_tok = false;
    while (p < end && *p != '\n') {
        bool sp = std::isspace((unsigned char)*p);
        if (!sp && !in_tok) { ++n; in_tok = true; }
        if (sp) in_tok = false;
        ++p;
    }
    return n;
}

}  // extern "C"

extern "C" {

// Format a float matrix as "%f"-style rows (6 decimals, space-separated,
// newline-terminated) into `out` (caller-allocated). Returns bytes written,
// or -1 if out_cap would be exceeded.
long format_float_matrix(const float* vals, long rows, long cols,
                         char* out, long out_cap) {
    char* p = out;
    char* end = out + out_cap;
    for (long r = 0; r < rows; ++r) {
        for (long c = 0; c < cols; ++c) {
            if (end - p < 32) return -1;
            int n = snprintf(p, 32, "%f", (double)vals[r * cols + c]);
            p += n;
            *p++ = (c + 1 == cols) ? '\n' : ' ';
        }
    }
    return (long)(p - out);
}

}  // extern "C"
