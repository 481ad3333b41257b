// Native hills-log event formatter — the hot text path of the reference's
// output_hill trace (lib/edm_bias.cpp:586-599): every hill round appends up
// to thousands of 8-decimal fixed lines.  The Python path of
// utils/hills_log.py defines the format; this formatter writes the same
// bytes with snprintf into a caller-owned buffer.
//
// Event reconstruction mirrors utils/hills_log.py exactly: drain slots emit
// 'b' (+'v' partial undo), new hills emit 'h' (+'u' undo for straddlers);
// capped-out hills log a zero-height 'h' without bumping the counter.
#include <cstdio>
#include <cstdint>

extern "C" {

// Returns bytes written (excluding NUL), or -1 if the buffer is too small.
// Arrays are as in RoundRecords (bias.py); pos arrays are (n, dim).
long edm_format_round(
    char* out, long out_cap,
    long step, int dim, double cum_over_vol,
    // drain phase
    long n_drain, const double* drain_pos, const double* drain_h,
    const double* drain_dep_h, const double* drain_s,
    const uint8_t* drain_processed, const uint8_t* drain_straddled,
    // hill phase
    long n_hills, const double* hill_pos, const double* hill_h,
    const double* hill_dep_h, const double* hill_s,
    const uint8_t* hill_called, const uint8_t* hill_deposited,
    const uint8_t* hill_straddled) {
  long off = 0;
  long counter = 0;
  auto line = [&](char type, long ctr, const double* p, double h,
                  double bias_added) -> bool {
    if (out_cap - off < 64 + 24 * dim) return false;
    off += snprintf(out + off, out_cap - off, "%ld %c %ld ", step, type, ctr);
    for (int d = 0; d < dim; d++)
      off += snprintf(out + off, out_cap - off, "%.8f ", p[d]);
    off += snprintf(out + off, out_cap - off, "%.8f %.8f %.8f\n", h,
                    bias_added, cum_over_vol);
    return true;
  };

  for (long i = 0; i < n_drain; i++) {
    if (!drain_processed[i]) continue;
    counter++;
    if (!line('b', counter, drain_pos + i * dim, drain_h[i],
              drain_h[i] * drain_s[i]))
      return -1;
    if (drain_straddled[i]) {
      double undo = drain_dep_h[i] - drain_h[i];
      counter++;
      if (!line('v', counter, drain_pos + i * dim, undo, undo * drain_s[i]))
        return -1;
    }
  }
  for (long i = 0; i < n_hills; i++) {
    if (!hill_called[i]) continue;
    if (hill_deposited[i]) {
      counter++;
      if (!line('h', counter, hill_pos + i * dim, hill_h[i],
                hill_h[i] * hill_s[i]))
        return -1;
      if (hill_straddled[i]) {
        double undo = hill_dep_h[i] - hill_h[i];
        counter++;
        if (!line('u', counter, hill_pos + i * dim, undo, undo * hill_s[i]))
          return -1;
      }
    } else {
      if (!line('h', counter, hill_pos + i * dim, 0.0, 0.0)) return -1;
    }
  }
  return off;
}

}  // extern "C"
