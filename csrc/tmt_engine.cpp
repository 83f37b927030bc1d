// tmt_engine.cpp — native C++ implementation of the tile-match game semantics.
//
// Role in the framework: high-performance host-side engine (CPU serving,
// data-generation, differential oracle for the JAX kernels).  It
// implements the same behavioural contract as tile_match_tpu's jitted kernels
// (which are themselves differentially verified against the reference
// implementation at /root/reference): state encoding (colour/kind channels,
// board.py:96-97 contract), lowest-row line detection with the extension pass
// (board.py:149-215), greedy classification (board.py:269-327), DFS special
// activation (board.py:473-556), combination matches (board.py:600-726),
// gravity/refill (board.py:217-241) and the effective-move window test
// (board.py:735-787).
//
// Exposed as a C ABI for ctypes (see tile_match_tpu/native.py).
//
// Build: g++ -O3 -march=native -shared -fPIC -std=c++17 -o libtmt.so tmt_engine.cpp

#include <cstdint>
#include <cstring>
#include <vector>
#include <array>
#include <algorithm>
#include <utility>

namespace {

using Coord = std::pair<int, int>;

constexpr int KIND_EMPTY = 0;
constexpr int KIND_NORMAL = 1;
constexpr int KIND_VLASER = 2;
constexpr int KIND_HLASER = 3;
constexpr int KIND_BOMB = 4;
constexpr int KIND_COOKIE = -1;

constexpr int FLAG_COOKIE = 1;
constexpr int FLAG_VLASER = 2;
constexpr int FLAG_HLASER = 4;
constexpr int FLAG_BOMB = 8;

enum MatchType { M_NORMAL = 1, M_VLASER = 2, M_HLASER = 3, M_BOMB = 4, M_COOKIE = 5 };

struct Board {
  int R, C;
  int32_t* colour;
  int32_t* kind;
  int32_t& col(int r, int c) { return colour[r * C + c]; }
  int32_t& knd(int r, int c) { return kind[r * C + c]; }
  int32_t colv(int r, int c) const { return colour[r * C + c]; }
  int32_t kndv(int r, int c) const { return kind[r * C + c]; }
  bool special(int r, int c) const {
    int k = kndv(r, c);
    return k != KIND_EMPTY && k != KIND_NORMAL;
  }
  void del(int r, int c) { col(r, c) = 0; knd(r, c) = 0; }
};

struct Stats {
  int activated = 0;
  int created = 0;
};

// ---------------------------------------------------------------------------
// Line detection: primary lines anchored in the lowest matching row, plus the
// truncated perpendicular/parallel extension pass.  Line order and coord
// order match the verified contract exactly.
// ---------------------------------------------------------------------------
std::vector<std::vector<Coord>> get_colour_lines(const Board& b) {
  const int R = b.R, C = b.C;
  std::vector<std::vector<Coord>> lines;

  // lowest row containing a horizontal run >=3 or the bottom of a vertical
  // run >=3.
  int r0 = -1;
  for (int r = R - 1; r >= 0 && r0 < 0; --r) {
    for (int c = 0; c < C; ++c) {
      int v = b.colv(r, c);
      if (v <= 0) continue;
      // bottom of vertical run >=3?
      if (r >= 2 && b.colv(r - 1, c) == v && b.colv(r - 2, c) == v &&
          (r == R - 1 || b.colv(r + 1, c) != v)) {
        r0 = r;
        break;
      }
      // horizontal run >=3 through this row?
      if (c + 2 < C && b.colv(r, c + 1) == v && b.colv(r, c + 2) == v) {
        r0 = r;
        break;
      }
    }
  }
  if (r0 < 0) return lines;

  // primary lines: column order, vertical before horizontal at each column.
  std::vector<uint8_t> primary(R * C, 0);
  for (int c = 0; c < C; ++c) {
    int v = b.colv(r0, c);
    if (v > 0) {
      // vertical with bottom at r0
      if ((r0 == R - 1 || b.colv(r0 + 1, c) != v) && r0 >= 2 &&
          b.colv(r0 - 1, c) == v && b.colv(r0 - 2, c) == v) {
        int top = r0 - 2;
        while (top > 0 && b.colv(top - 1, c) == v) --top;
        std::vector<Coord> line;
        for (int r = top; r <= r0; ++r) {
          line.emplace_back(r, c);
          primary[r * C + c] = 1;
        }
        lines.push_back(std::move(line));
      }
      // horizontal starting at c
      if ((c == 0 || b.colv(r0, c - 1) != v) && c + 2 < C &&
          b.colv(r0, c + 1) == v && b.colv(r0, c + 2) == v) {
        int e = c + 2;
        while (e + 1 < C && b.colv(r0, e + 1) == v) ++e;
        std::vector<Coord> line;
        for (int cc = c; cc <= e; ++cc) {
          line.emplace_back(r0, cc);
          primary[r0 * C + cc] = 1;
        }
        lines.push_back(std::move(line));
      }
    }
  }

  // extension pass: for each primary coord (first occurrence, line order),
  // the maximal same-colour segment through it truncated at other primary
  // coords; horizontal candidate before vertical; >=3 → new line.
  std::vector<uint8_t> visited(R * C, 0);
  size_t n_primary = lines.size();
  for (size_t li = 0; li < n_primary; ++li) {
    for (const Coord& g : lines[li]) {
      int gr = g.first, gc = g.second;
      if (visited[gr * C + gc]) continue;
      visited[gr * C + gc] = 1;
      int v = b.colv(gr, gc);
      // horizontal extension
      {
        int lo = gc, hi = gc;
        while (hi + 1 < C && !primary[gr * C + hi + 1] && b.colv(gr, hi + 1) == v)
          ++hi;
        while (lo - 1 >= 0 && !primary[gr * C + lo - 1] && b.colv(gr, lo - 1) == v)
          --lo;
        if (hi - lo + 1 >= 3) {
          std::vector<Coord> line;
          for (int cc = lo; cc <= hi; ++cc) line.emplace_back(gr, cc);
          lines.push_back(std::move(line));
        }
      }
      // vertical extension
      {
        int lo = gr, hi = gr;
        while (hi + 1 < R && !primary[(hi + 1) * C + gc] && b.colv(hi + 1, gc) == v)
          ++hi;
        while (lo - 1 >= 0 && !primary[(lo - 1) * C + gc] && b.colv(lo - 1, gc) == v)
          --lo;
        if (hi - lo + 1 >= 3) {
          std::vector<Coord> line;
          for (int rr = lo; rr <= hi; ++rr) line.emplace_back(rr, gc);
          lines.push_back(std::move(line));
        }
      }
    }
  }
  return lines;
}

bool has_any_line(const Board& b) {
  for (int r = 0; r < b.R; ++r)
    for (int c = 0; c < b.C; ++c) {
      int v = b.colv(r, c);
      if (v <= 0) continue;
      if (c + 2 < b.C && b.colv(r, c + 1) == v && b.colv(r, c + 2) == v)
        return true;
      if (r + 2 < b.R && b.colv(r + 1, c) == v && b.colv(r + 2, c) == v)
        return true;
    }
  return false;
}

// ---------------------------------------------------------------------------
// Greedy classification queue.
// ---------------------------------------------------------------------------
struct Match {
  std::vector<Coord> coords;
  int type;
  int colour;
};

std::vector<Match> classify(const Board& b, std::vector<std::vector<Coord>> lines,
                            int flags) {
  std::vector<Match> out;
  // stable sort by topmost coord's row
  std::stable_sort(lines.begin(), lines.end(),
                   [](const auto& a, const auto& c) {
                     return a.front().first < c.front().first;
                   });
  std::vector<std::vector<Coord>> q(lines.begin(), lines.end());
  while (!q.empty()) {
    std::vector<Coord> line = std::move(q.front());
    q.erase(q.begin());
    int n = (int)line.size();
    if ((flags & FLAG_COOKIE) && n >= 5) {
      Match m;
      m.coords.assign(line.begin(), line.begin() + 5);
      m.type = M_COOKIE;
      m.colour = 0;
      out.push_back(std::move(m));
      if (n - 5 > 2)
        q.emplace_back(line.begin() + 5, line.end());
      continue;
    }
    if (n == 4) {
      Match m;
      m.coords = line;
      m.colour = b.colv(line[0].first, line[0].second);
      bool horiz = line[0].first == line[1].first;
      if (horiz && (flags & FLAG_HLASER)) m.type = M_HLASER;
      else if (flags & FLAG_VLASER) m.type = M_VLASER;
      else m.type = M_NORMAL;
      out.push_back(std::move(m));
      continue;
    }
    if (flags & FLAG_BOMB) {
      // first queued line sharing a coord with this one
      int partner = -1;
      Coord shared{-1, -1};
      for (size_t i = 0; i < q.size() && partner < 0; ++i) {
        for (const Coord& c : line) {
          if (std::find(q[i].begin(), q[i].end(), c) != q[i].end()) {
            partner = (int)i;
            shared = c;
            break;
          }
        }
      }
      if (partner >= 0 && n >= 3) {
        auto& l = q[partner];
        // 3 closest partner coords to the shared coord (stable Manhattan)
        std::vector<int> idx(l.size());
        for (size_t i = 0; i < l.size(); ++i) idx[i] = (int)i;
        std::stable_sort(idx.begin(), idx.end(), [&](int a, int c) {
          int da = std::abs(l[a].first - shared.first) +
                   std::abs(l[a].second - shared.second);
          int dc = std::abs(l[c].first - shared.first) +
                   std::abs(l[c].second - shared.second);
          return da < dc;
        });
        Match m;
        m.coords = line;
        std::vector<Coord> taken3;
        for (int t = 0; t < 3 && t < (int)idx.size(); ++t) {
          Coord p = l[idx[t]];
          taken3.push_back(p);
          if (std::find(line.begin(), line.end(), p) == line.end())
            m.coords.push_back(p);
        }
        m.type = M_BOMB;
        m.colour = b.colv(line[0].first, line[0].second);
        out.push_back(std::move(m));
        if ((int)l.size() < 6) {
          q.erase(q.begin() + partner);
        } else {
          for (const Coord& p : taken3)
            l.erase(std::find(l.begin(), l.end(), p));
        }
        continue;
      }
    }
    if (n >= 3) {
      Match m;
      m.coords = line;
      m.type = M_NORMAL;
      m.colour = b.colv(line[0].first, line[0].second);
      out.push_back(std::move(m));
    }
  }
  return out;
}

// ---------------------------------------------------------------------------
// Activation (DFS, counted vs combination-uncounted).
// ---------------------------------------------------------------------------
void activate(Board& b, int r, int c, int kind_at, Stats& st, bool counted);

void scan_mask_colour(Board& b, int colour, Stats& st, bool counted) {
  // visit current specials of the given colour in row-major order,
  // re-checking before each (deeper chains may delete later entries).
  for (int r = 0; r < b.R; ++r)
    for (int c = 0; c < b.C; ++c)
      if (b.colv(r, c) == colour && b.kndv(r, c) > 1)
        activate(b, r, c, b.kndv(r, c), st, counted);
}

bool board_colour_dead(const Board& b) {
  for (int i = 0; i < b.R * b.C; ++i)
    if (b.colour[i] != 0) return false;
  return true;
}

void activate(Board& b, int r, int c, int kind_at, Stats& st, bool counted) {
  if (board_colour_dead(b)) return;  // silent no-op on colourless boards
  b.del(r, c);
  if (counted) st.activated++;
  switch (kind_at) {
    case KIND_VLASER:
      for (int rr = 0; rr < b.R; ++rr) {
        if (b.special(rr, c)) activate(b, rr, c, b.kndv(rr, c), st, true);
        else b.del(rr, c);
      }
      break;
    case KIND_HLASER:
      for (int cc = 0; cc < b.C; ++cc) {
        if (b.special(r, cc)) activate(b, r, cc, b.kndv(r, cc), st, true);
        else b.del(r, cc);
      }
      break;
    case KIND_BOMB:
      for (int rr = std::max(r - 1, 0); rr <= std::min(r + 1, b.R - 1); ++rr)
        for (int cc = std::max(c - 1, 0); cc <= std::min(c + 1, b.C - 1); ++cc) {
          if (b.special(rr, cc)) activate(b, rr, cc, b.kndv(rr, cc), st, true);
          else b.del(rr, cc);
        }
      break;
    case KIND_COOKIE: {
      // most common non-zero colour (ties → smallest)
      std::vector<int> counts(64, 0);
      int maxc = 0;
      for (int i = 0; i < b.R * b.C; ++i) {
        int v = b.colour[i];
        if (v > 0 && v < 64) { counts[v]++; maxc = std::max(maxc, v); }
      }
      int best = 0, bestn = -1;
      for (int v = 1; v <= maxc; ++v)
        if (counts[v] > bestn) { bestn = counts[v]; best = v; }
      if (bestn <= 0) return;
      for (int i = 0; i < b.R * b.C; ++i)
        if (b.colour[i] == best && b.kind[i] == KIND_NORMAL) {
          b.colour[i] = 0; b.kind[i] = 0;
        }
      scan_mask_colour(b, best, st, true);
      break;
    }
    default:
      break;  // invalid kinds never reach here from verified callers
  }
}

// ---------------------------------------------------------------------------
// Resolution: creation positions, eliminate/activate, create specials.
// ---------------------------------------------------------------------------
Coord creation_pos(const Match& m, const std::vector<Coord>& taken) {
  std::vector<Coord> valid;
  for (const Coord& c : m.coords)
    if (std::find(taken.begin(), taken.end(), c) == taken.end())
      valid.push_back(c);
  if (valid.empty()) return m.coords.front();
  if (m.type == M_BOMB) {
    // corner = (mode of rows, mode of cols) over ALL coords, first-max
    auto mode = [&](bool row) {
      int best = -1, bestn = -1;
      for (const Coord& c : m.coords) {
        int v = row ? c.first : c.second;
        int n = 0;
        for (const Coord& d : m.coords)
          n += (row ? d.first : d.second) == v;
        if (n > bestn) { bestn = n; best = v; }
      }
      return best;
    };
    Coord corner{mode(true), mode(false)};
    if (std::find(valid.begin(), valid.end(), corner) != valid.end())
      return corner;
    Coord best = valid[0];
    long bestd = 1L << 60;
    for (const Coord& c : valid) {
      long d = (long)(c.first - corner.first) * (c.first - corner.first) +
               (long)(c.second - corner.second) * (c.second - corner.second);
      if (d < bestd) { bestd = d; best = c; }
    }
    return best;
  }
  std::vector<Coord> sorted_valid = valid;
  std::sort(sorted_valid.begin(), sorted_valid.end());
  size_t n = sorted_valid.size();
  return sorted_valid[n % 2 == 0 ? n / 2 - 1 : n / 2];
}

bool resolve_once(Board& b, int flags, Stats& st) {
  auto lines = get_colour_lines(b);
  if (lines.empty()) return false;
  auto matches = classify(b, std::move(lines), flags);

  // creation queue first (before any deletion)
  std::vector<Coord> taken;
  std::vector<std::array<int, 4>> queue;  // r, c, type, colour
  for (const Match& m : matches) {
    if (m.type == M_NORMAL) continue;
    Coord p = creation_pos(m, taken);
    taken.push_back(p);
    queue.push_back({p.first, p.second, m.type, m.colour});
  }
  // eliminate / activate
  for (const Match& m : matches)
    for (const Coord& c : m.coords) {
      if (b.special(c.first, c.second))
        activate(b, c.first, c.second, b.kndv(c.first, c.second), st, true);
      else
        b.del(c.first, c.second);
    }
  // create specials
  for (const auto& qe : queue) {
    st.created++;
    b.col(qe[0], qe[1]) = qe[3];
    b.knd(qe[0], qe[1]) = qe[2] == M_COOKIE ? KIND_COOKIE : qe[2];
  }
  return true;
}

// ---------------------------------------------------------------------------
// Combinations.
// ---------------------------------------------------------------------------
bool is_comb(const Board& b, int r1, int c1, int r2, int c2) {
  int k1 = b.kndv(r1, c1), k2 = b.kndv(r2, c2);
  bool two = (k1 != 0 && k1 != 1) && (k2 != 0 && k2 != 1);
  return two || k1 < 0 || k2 < 0;
}

int combination(Board& b, int r1, int c1, int r2, int c2, Stats& st) {
  int k1 = b.kndv(r1, c1), k2 = b.kndv(r2, c2);
  int col1 = b.colv(r1, c1), col2 = b.colv(r2, c2);
  int before = st.activated;
  st.activated += 2;
  auto laser = [](int k) { return k == KIND_VLASER || k == KIND_HLASER; };

  if (k1 == KIND_COOKIE && k2 == KIND_COOKIE) {
    std::memset(b.colour, 0, sizeof(int32_t) * b.R * b.C);
    std::memset(b.kind, 0, sizeof(int32_t) * b.R * b.C);
  } else if ((k1 == KIND_COOKIE && k2 == KIND_NORMAL) ||
             (k1 == KIND_NORMAL && k2 == KIND_COOKIE)) {
    st.activated -= 1;
    int cr = k1 == KIND_COOKIE ? r1 : r2, cc = k1 == KIND_COOKIE ? c1 : c2;
    int ocol = k1 == KIND_COOKIE ? col2 : col1;
    b.del(cr, cc);
    for (int i = 0; i < b.R * b.C; ++i)
      if (b.colour[i] == ocol && b.kind[i] == KIND_NORMAL) {
        b.colour[i] = 0; b.kind[i] = 0;
      }
    scan_mask_colour(b, ocol, st, false);
  } else if ((k1 == KIND_COOKIE && k2 >= 2) || (k1 >= 2 && k2 == KIND_COOKIE)) {
    int cr = k1 == KIND_COOKIE ? r1 : r2, cc = k1 == KIND_COOKIE ? c1 : c2;
    int ok = k1 == KIND_COOKIE ? k2 : k1;
    int ocol = k1 == KIND_COOKIE ? col2 : col1;
    b.del(cr, cc);
    for (int i = 0; i < b.R * b.C; ++i)
      if (b.colour[i] == ocol && b.kind[i] == KIND_NORMAL)
        b.kind[i] = ok;
    scan_mask_colour(b, ocol, st, false);
  } else if (laser(k1) && laser(k2)) {
    b.del(r1, c1);
    b.del(r2, c2);
    int r = std::min(r1, r2), c = std::min(c1, c2);
    activate(b, r, c, KIND_VLASER, st, false);
    activate(b, r, c, KIND_HLASER, st, false);
  } else if ((k1 == KIND_BOMB && laser(k2)) || (k2 == KIND_BOMB && laser(k1))) {
    b.del(r1, c1);
    b.del(r2, c2);
    int r = std::min(r1, r2), c = std::min(c1, c2);
    for (int rr = std::max(r - 1, 0); rr <= std::min(r + 1, b.R - 1); ++rr)
      activate(b, rr, c, KIND_HLASER, st, false);
    for (int cc = std::max(c - 1, 0); cc <= std::min(c + 1, b.C - 1); ++cc)
      activate(b, r, cc, KIND_VLASER, st, false);
  } else if (k1 == KIND_BOMB && k2 == KIND_BOMB) {
    b.del(r1, c1);
    b.del(r2, c2);
    int r = std::min(r1, r2), c = std::min(c1, c2);
    for (int rr = std::max(r - 2, 0); rr <= std::min(r + 2, b.R - 1); ++rr)
      for (int cc = std::max(c - 2, 0); cc <= std::min(c + 2, b.C - 1); ++cc) {
        if (b.kndv(rr, cc) == KIND_NORMAL) b.del(rr, cc);
        else if (b.kndv(rr, cc) != KIND_EMPTY)
          activate(b, rr, cc, b.kndv(rr, cc), st, false);
      }
  }
  return st.activated - before;
}

// ---------------------------------------------------------------------------
// Board plumbing: gravity, refill, effective mask, xorshift RNG.
// ---------------------------------------------------------------------------
void gravity(Board& b) {
  for (int c = 0; c < b.C; ++c) {
    int write = b.R - 1;
    for (int r = b.R - 1; r >= 0; --r) {
      if (!(b.colv(r, c) == 0 && b.kndv(r, c) == 0)) {
        if (write != r) {
          b.col(write, c) = b.colv(r, c);
          b.knd(write, c) = b.kndv(r, c);
        }
        --write;
      }
    }
    for (; write >= 0; --write) { b.col(write, c) = 0; b.knd(write, c) = 0; }
  }
}

uint64_t xorshift(uint64_t* s) {
  uint64_t x = *s;
  x ^= x << 13;
  x ^= x >> 7;
  x ^= x << 17;
  return *s = x;
}

int rand_colour(uint64_t* s, int num_colours) {
  return 1 + (int)(xorshift(s) % (uint64_t)num_colours);
}

void refill_rng(Board& b, int num_colours, uint64_t* rng) {
  for (int i = 0; i < b.R * b.C; ++i)
    if (b.colour[i] == 0 && b.kind[i] == 0) {
      b.colour[i] = rand_colour(rng, num_colours);
      b.kind[i] = 1;
    }
}

bool window_match_after_swap(Board& b, int r1, int c1, int r2, int c2) {
  std::swap(b.col(r1, c1), b.col(r2, c2));
  std::swap(b.knd(r1, c1), b.knd(r2, c2));
  int rmin = std::max(0, std::min(r1, r2) - 2);
  int rmax = std::min(b.R - 1, std::max(r1, r2) + 2);
  int cmin = std::max(0, std::min(c1, c2) - 2);
  int cmax = std::min(b.C - 1, std::max(c1, c2) + 2);
  bool found = false;
  for (int r = rmin; r <= rmax && !found; ++r)
    for (int c = cmin; c + 2 <= cmax; ++c)
      if (b.colv(r, c) == b.colv(r, c + 1) &&
          b.colv(r, c + 1) == b.colv(r, c + 2) && b.kndv(r, c + 2) >= 0) {
        found = true;
        break;
      }
  for (int c = cmin; c <= cmax && !found; ++c)
    for (int r = rmin; r + 2 <= rmax; ++r)
      if (b.colv(r, c) == b.colv(r + 1, c) &&
          b.colv(r + 1, c) == b.colv(r + 2, c) && b.kndv(r + 2, c) >= 0) {
        found = true;
        break;
      }
  std::swap(b.col(r1, c1), b.col(r2, c2));
  std::swap(b.knd(r1, c1), b.knd(r2, c2));
  return found;
}

bool move_effective(Board& b, int r1, int c1, int r2, int c2) {
  int k1 = b.kndv(r1, c1), k2 = b.kndv(r2, c2);
  if ((k1 != 0 && k1 != 1) && (k2 != 0 && k2 != 1)) return true;
  if (k1 < 0 || k2 < 0) return true;
  return window_match_after_swap(b, r1, c1, r2, c2);
}

void action_coords(int R, int C, int a, int* r1, int* c1, int* r2, int* c2) {
  int n_down = C * (R - 1);
  if (a < n_down) {
    *r1 = a / C; *c1 = a % C; *r2 = *r1 + 1; *c2 = *c1;
  } else {
    int j = a - n_down;
    *r1 = j / (C - 1); *c1 = j % (C - 1); *r2 = *r1; *c2 = *c1 + 1;
  }
}

bool possible_move(Board& b) {
  int A = 2 * b.R * b.C - b.R - b.C;
  for (int a = 0; a < A; ++a) {
    int r1, c1, r2, c2;
    action_coords(b.R, b.C, a, &r1, &c1, &r2, &c2);
    if (move_effective(b, r1, c1, r2, c2)) return true;
  }
  return false;
}

void shuffle_rng(Board& b, uint64_t* rng) {
  int n = b.R * b.C;
  std::vector<int> perm(n);
  for (int i = 0; i < n; ++i) perm[i] = i;
  for (int i = n - 1; i > 0; --i) {
    int j = (int)(xorshift(rng) % (uint64_t)(i + 1));
    std::swap(perm[i], perm[j]);
  }
  std::vector<int32_t> ncol(n), nknd(n);
  for (int i = 0; i < n; ++i) { ncol[i] = b.colour[perm[i]]; nknd[i] = b.kind[perm[i]]; }
  std::memcpy(b.colour, ncol.data(), n * 4);
  std::memcpy(b.kind, nknd.data(), n * 4);
}

// top-row of the first detected line (for the re-roll loop)
int first_line_top(const Board& b) {
  auto lines = get_colour_lines(b);
  if (lines.empty()) return -1;
  return lines.front().front().first;
}

void remove_lines_rng(Board& b, int num_colours, uint64_t* rng) {
  int top = first_line_top(b);
  while (top >= 0) {
    int bound = std::min(b.R - 1, top + 1);
    for (int r = 0; r <= bound; ++r)
      for (int c = 0; c < b.C; ++c)
        b.col(r, c) = rand_colour(rng, num_colours);
    top = first_line_top(b);
  }
}

bool playability_rng(Board& b, int num_colours, uint64_t* rng, bool lines_known,
                     int known_top) {
  bool shuffled = false;
  bool has_lines = lines_known && known_top >= 0;
  int top = known_top;
  while (!possible_move(b) || has_lines) {
    if (has_lines) {
      remove_lines_rng(b, num_colours, rng);
    } else {
      shuffled = true;
      shuffle_rng(b, rng);
    }
    top = first_line_top(b);
    has_lines = top >= 0;
  }
  return shuffled;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------
extern "C" {

int tmt_num_actions(int R, int C) { return 2 * R * C - R - C; }

void tmt_effective_mask(int32_t* colour, int32_t* kind, int R, int C,
                        uint8_t* out) {
  Board b{R, C, colour, kind};
  int A = tmt_num_actions(R, C);
  for (int a = 0; a < A; ++a) {
    int r1, c1, r2, c2;
    action_coords(R, C, a, &r1, &c1, &r2, &c2);
    out[a] = move_effective(b, r1, c1, r2, c2) ? 1 : 0;
  }
}

void tmt_gravity(int32_t* colour, int32_t* kind, int R, int C) {
  Board b{R, C, colour, kind};
  gravity(b);
}

void tmt_apply_refill(int32_t* colour, int32_t* kind, const int32_t* grid,
                      int R, int C) {
  for (int i = 0; i < R * C; ++i)
    if (colour[i] == 0 && kind[i] == 0) { colour[i] = grid[i]; kind[i] = 1; }
}

void tmt_swap(int32_t* colour, int32_t* kind, int R, int C, int r1, int c1,
              int r2, int c2) {
  Board b{R, C, colour, kind};
  std::swap(b.col(r1, c1), b.col(r2, c2));
  std::swap(b.knd(r1, c1), b.knd(r2, c2));
}

// One cascade iteration (detect+classify+resolve, no gravity/refill).
// stats_out[0] += activated, stats_out[1] += created. Returns had_match.
int tmt_resolve_once(int32_t* colour, int32_t* kind, int R, int C, int flags,
                     int* stats_out) {
  Board b{R, C, colour, kind};
  Stats st;
  bool had = resolve_once(b, flags, st);
  stats_out[0] += st.activated;
  stats_out[1] += st.created;
  return had ? 1 : 0;
}

int tmt_is_combination(int32_t* colour, int32_t* kind, int R, int C, int r1,
                       int c1, int r2, int c2) {
  Board b{R, C, colour, kind};
  return is_comb(b, r1, c1, r2, c2) ? 1 : 0;
}

// Returns activated delta (including the +2/-1 accounting).
int tmt_combination(int32_t* colour, int32_t* kind, int R, int C, int r1,
                    int c1, int r2, int c2) {
  Board b{R, C, colour, kind};
  Stats st;
  return combination(b, r1, c1, r2, c2, st);
}

// Full native move with internal xorshift RNG (production CPU path; the RNG
// stream is this engine's own, like the JAX engine's threefry mode).
// stats_out: [is_comb, new_specials, activated, shuffled]. Returns eliminations.
int tmt_move(int32_t* colour, int32_t* kind, int R, int C, int flags,
             int num_colours, int r1, int c1, int r2, int c2,
             uint64_t* rng_state, int* stats_out) {
  Board b{R, C, colour, kind};
  Stats st;
  int elim = 0;
  stats_out[0] = stats_out[1] = stats_out[2] = stats_out[3] = 0;
  if (!move_effective(b, r1, c1, r2, c2)) return 0;
  std::swap(b.col(r1, c1), b.col(r2, c2));
  std::swap(b.knd(r1, c1), b.knd(r2, c2));

  if (is_comb(b, r1, c1, r2, c2)) {
    stats_out[0] = 1;
    combination(b, r1, c1, r2, c2, st);
    for (int i = 0; i < R * C; ++i) elim += kind[i] == 0;
    gravity(b);
    refill_rng(b, num_colours, rng_state);
  }
  while (resolve_once(b, flags, st)) {
    for (int i = 0; i < R * C; ++i) elim += kind[i] == 0;
    gravity(b);
    refill_rng(b, num_colours, rng_state);
  }
  elim += st.created;
  bool shuffled = playability_rng(b, num_colours, rng_state, true, -1);
  stats_out[1] = st.created;
  stats_out[2] = st.activated;
  stats_out[3] = shuffled ? 1 : 0;
  return elim;
}

void tmt_generate(int32_t* colour, int32_t* kind, int R, int C, int flags,
                  int num_colours, uint64_t* rng_state) {
  Board b{R, C, colour, kind};
  for (int i = 0; i < R * C; ++i) {
    colour[i] = rand_colour(rng_state, num_colours);
    kind[i] = 1;
  }
  int top = first_line_top(b);
  playability_rng(b, num_colours, rng_state, true, top);
}

int tmt_possible_move(int32_t* colour, int32_t* kind, int R, int C) {
  Board b{R, C, colour, kind};
  return possible_move(b) ? 1 : 0;
}

int tmt_has_any_line(int32_t* colour, int32_t* kind, int R, int C) {
  Board b{R, C, colour, kind};
  return has_any_line(b) ? 1 : 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Batched API — env-pool-style CPU stepping (OpenMP across boards).
// colour/kind: int32[B, R, C]; actions: int32[B]; rng: uint64[B];
// rewards/stats out: int32[B] / int32[B, 4].  Auto-resets finished episodes.
// ---------------------------------------------------------------------------
extern "C" {

void tmt_batch_generate(int32_t* colour, int32_t* kind, int B, int R, int C,
                        int flags, int num_colours, uint64_t* rng_states) {
#pragma omp parallel for schedule(dynamic)
  for (int b = 0; b < B; ++b)
    tmt_generate(colour + (size_t)b * R * C, kind + (size_t)b * R * C, R, C,
                 flags, num_colours, rng_states + b);
}

void tmt_batch_move(int32_t* colour, int32_t* kind, int B, int R, int C,
                    int flags, int num_colours, const int32_t* actions,
                    uint64_t* rng_states, int32_t* rewards,
                    int32_t* stats /* [B,4] */) {
#pragma omp parallel for schedule(dynamic)
  for (int b = 0; b < B; ++b) {
    int r1, c1, r2, c2;
    action_coords(R, C, actions[b], &r1, &c1, &r2, &c2);
    int st[4];
    rewards[b] = tmt_move(colour + (size_t)b * R * C,
                          kind + (size_t)b * R * C, R, C, flags, num_colours,
                          r1, c1, r2, c2, rng_states + b, st);
    for (int i = 0; i < 4; ++i) stats[b * 4 + i] = st[i];
  }
}

void tmt_batch_effective_mask(int32_t* colour, int32_t* kind, int B, int R,
                              int C, uint8_t* out /* [B, A] */) {
  int A = tmt_num_actions(R, C);
#pragma omp parallel for schedule(static)
  for (int b = 0; b < B; ++b)
    tmt_effective_mask(colour + (size_t)b * R * C, kind + (size_t)b * R * C,
                       R, C, out + (size_t)b * A);
}

}  // extern "C"
