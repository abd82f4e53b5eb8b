// Fast whitespace-delimited float matrix parser and "%f" formatter for BVH
// motion data.
//
// The data pipeline parses 67 clips x 2 time-stretches of ~8k-frame BVH
// motion blocks (~3.5M floats per clip). NumPy's loadtxt tokenizes per
// line through Python; this parser is a single strtof sweep over the
// buffer (~100x less overhead) exposed through a C ABI for ctypes.
//
// Built on first use with the host C++ compiler by zeggs_tpu_torch/io/native.py
// (into build/zeggs_tpu_torch/); host code, not a CUDA kernel.

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

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

// Six-decimal fixed point, exactly as glibc's "%f" prints a float. For a
// finite float with |v| < kExact, |v| * 1e6 is exact in a double (24
// significant bits times 15625's 14) and under 2^63, so rounding it to an
// integer under the default rounding mode (to nearest, ties to even, as
// "%f" rounds the exact binary value) gives the printed digits. Any other
// value goes through snprintf.
namespace {

constexpr double kExact = 9e12;
// The widest finite float's "%f" is 47 characters ("-340282346638528859811
// 704183484516925440.000000"); its slot holds them and the separator.
constexpr long kSlot = 48;

const char kPairs[] =
    "00010203040506070809101112131415161718192021222324252627282930313233343536373839"
    "40414243444546474849505152535455565758596061626364656667686970717273747576777879"
    "8081828384858687888990919293949596979899";

inline char* put_pair(char* p, unsigned v) {
    std::memcpy(p, kPairs + 2 * v, 2);
    return p + 2;
}

inline char* put_fixed6(char* p, double a) {
    uint64_t u = (uint64_t)std::nearbyint(a * 1e6);
    uint64_t ip = u / 1000000;
    unsigned fp = (unsigned)(u % 1000000);
    char digits[20];
    char* d = digits + sizeof digits;
    do {
        *--d = (char)('0' + ip % 10);
    } while (ip /= 10);
    long n = digits + sizeof digits - d;
    std::memcpy(p, d, n);
    p += n;
    *p++ = '.';
    p = put_pair(p, fp / 10000);
    p = put_pair(p, fp / 100 % 100);
    return put_pair(p, fp % 100);
}

}  // namespace

extern "C" {

// Format a float matrix as "%f" rows (6 decimals, space-separated,
// newline-terminated) into `out`, which holds at least rows * cols * 48
// bytes. Stores in *n_fallback how many values went through snprintf (NaN,
// infinities, |v| >= 9e12). Returns the bytes written, or -1 if out_cap is
// smaller than that.
long format_float_matrix(const float* vals, long rows, long cols,
                         char* out, long out_cap, long* n_fallback) {
    if (out_cap < rows * cols * kSlot) return -1;
    char* p = out;
    long fallback = 0;
    for (long i = 0, n = rows * cols; i < n; ++i) {
        double v = vals[i];
        double a = std::fabs(v);
        if (a < kExact) {
            if (std::signbit(v)) *p++ = '-';
            p = put_fixed6(p, a);
        } else {
            ++fallback;
            // Python's "%f" prints a NaN as "nan" whatever its sign bit,
            // where glibc prints "-nan" for the sign-bit NaN that x86
            // arithmetic makes; the text follows Python's.
            p += std::isnan(v) ? snprintf(p, kSlot, "nan") : snprintf(p, kSlot, "%f", v);
        }
        *p++ = (i + 1) % cols == 0 ? '\n' : ' ';
    }
    *n_fallback = fallback;
    return (long)(p - out);
}

}  // extern "C"
