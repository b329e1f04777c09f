// Fast XYZ trajectory parser (native side of normalizingflow_tpu_torch.io).
//
// One buffered read of the whole file and a single strtod sweep, with no
// per-line Python objects; io/xyz.py falls back to a pure-Python parser
// when this library cannot be built.
//
// C ABI (consumed via ctypes from io/_build.py):
//   cxyz_read(path, &data, &n_frames, &n_atoms) -> 0 on success
//     data: malloc'd double[n_frames * n_atoms * 3] (row-major), caller
//     frees via cxyz_free.
//   cxyz_free(data)
//
// Build: io/_build.py invokes g++ -O3 -shared -fPIC at first use and caches
// the library under the package's _build/ directory.

#include <cctype>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

static const char *skip_ws(const char *p, const char *end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) p++;
    return p;
}

static const char *next_line(const char *p, const char *end) {
    while (p < end && *p != '\n') p++;
    return p < end ? p + 1 : end;
}

// Parse one frame starting at *p. Returns 0 on success, 1 on EOF, -1 on
// malformed input.
static int parse_frame(const char **pp, const char *end,
                       std::vector<double> &out, long *natoms_out) {
    const char *p = skip_ws(*pp, end);
    while (p < end && (*p == '\n')) p = skip_ws(p + 1, end);
    if (p >= end) return 1;

    char *q;
    long natoms = strtol(p, &q, 10);
    if (q == p || natoms <= 0) return -1;
    p = next_line(q, end);  // rest of the natoms line
    p = next_line(p, end);  // comment line

    for (long i = 0; i < natoms; i++) {
        p = skip_ws(p, end);
        if (p >= end) return -1;
        // skip the element/type token
        while (p < end && !isspace((unsigned char)*p)) p++;
        for (int c = 0; c < 3; c++) {
            double v = strtod(p, &q);
            if (q == p) return -1;
            out.push_back(v);
            p = q;
        }
        p = next_line(p, end);
    }
    *pp = p;
    *natoms_out = natoms;
    return 0;
}

int cxyz_read(const char *path, double **data, long *n_frames,
              long *n_atoms) {
    FILE *f = fopen(path, "rb");
    if (!f) return -1;
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    fseek(f, 0, SEEK_SET);
    char *buf = (char *)malloc(size + 1);
    if (!buf) { fclose(f); return -2; }
    if ((long)fread(buf, 1, size, f) != size) {
        free(buf); fclose(f); return -3;
    }
    fclose(f);
    buf[size] = '\0';

    std::vector<double> coords;
    coords.reserve(1 << 16);
    const char *p = buf;
    const char *end = buf + size;
    long natoms = 0, natoms_first = -1, frames = 0;
    for (;;) {
        int rc = parse_frame(&p, end, coords, &natoms);
        if (rc == 1) break;
        if (rc < 0) { free(buf); return -4; }
        if (natoms_first < 0) natoms_first = natoms;
        else if (natoms != natoms_first) { free(buf); return -5; }
        frames++;
    }
    free(buf);

    double *out = (double *)malloc(coords.size() * sizeof(double));
    if (!out) return -2;
    memcpy(out, coords.data(), coords.size() * sizeof(double));
    *data = out;
    *n_frames = frames;
    *n_atoms = natoms_first < 0 ? 0 : natoms_first;
    return 0;
}

void cxyz_free(double *data) { free(data); }

}  // extern "C"
