/* Fast text-numeric parsing for the data plane.
 *
 * Native equivalent of the reference's C++ Data_Reader hot paths
 * (magmaHC/Data_Reader.cpp:272-338: ~5117 edgel lines x 12 floats per
 * view, plus the start system and index tables).  numpy.loadtxt costs
 * ~200 ms per synthetic view; this strtod sweep is ~5 ms.  Compiled once
 * on demand into fastio.so and bound with ctypes
 * (utils/native.py) -- no Python.h dependency.
 */
#include <stdio.h>
#include <stdlib.h>

/* Parse every whitespace-separated numeric token in the file at `path`
 * into `out` (capacity `cap` doubles).  Returns the number of values
 * parsed, or -1 on open failure, or -(needed) if `cap` was too small
 * (call again with a bigger buffer). */
long fastio_parse_floats(const char *path, double *out, long cap) {
    FILE *f = fopen(path, "rb");
    if (!f) return -1;
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    fseek(f, 0, SEEK_SET);
    char *buf = (char *)malloc((size_t)size + 1);
    if (!buf) { fclose(f); return -1; }
    size_t got = fread(buf, 1, (size_t)size, f);
    fclose(f);
    buf[got] = '\0';

    long n = 0;
    char *p = buf;
    char *end = buf + got;
    while (p < end) {
        char *next;
        double v = strtod(p, &next);
        if (next == p) { p++; continue; }  /* skip non-numeric byte */
        if (n < cap) out[n] = v;
        n++;
        p = next;
    }
    free(buf);
    if (n > cap) return -n;
    return n;
}
