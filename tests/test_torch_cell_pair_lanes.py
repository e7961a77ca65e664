"""B1's lane map on the CPU: the host-visible part of the cell-pair engine
(``lane_of``, ``stripes``, ``stripe_lane`` in
src/repro_torch/kernels/cell_pair/csrc/cell_pair_engine.cuh), compiled
with the host g++ against tests/cell_pair_host_shim.h. For blocks of 32,
64, 128 and 1,024 lanes and every home count from 1 to the block size, a
small C++ program walks the chunk as the kernel's lanes do and checks that
every (home, row) pair is walked exactly once, that G = min(32, threads /
n_home), that G = 1 once the homes fill more than half the block, and that
the reduction reads each home's stripes s = 0 .. G - 1 in that order from
lanes that hold them. The Python mirror of the stripe rule
(``cell_pair.stripes``) is held to the C++ one. Skips without g++."""
import pathlib
import shutil
import subprocess

import pytest
import torch

from repro_torch.kernels.cell_pair import cell_pair as TCP
from repro_torch.kernels.cell_pair import codegen as CG

TESTS = pathlib.Path(__file__).resolve().parent
THREADS = (32, 64, 128, 1024)
# chunk row counts: fewer rows than stripes, a prime, a full chunk
ROWS = (1, 5, 37, 512)

LANE_CHECK = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>

int main(int argc, char** argv) {
  const int threads = std::atoi(argv[1]);
  if (argc > 2) {  // the stripe count of every home count, for Python's
    for (int n_home = 1; n_home <= threads; ++n_home)
      std::printf("%%d\n", stripes(n_home, threads));
    return 0;
  }
  const int rows[] = {%(rows)s};
  long walked = 0;
  for (int n_home = 1; n_home <= threads; ++n_home) {
    const int G = stripes(n_home, threads);
    const int want = threads / n_home < 32 ? threads / n_home : 32;
    if (G != want || G < 1 || n_home * G > threads ||
        (2 * n_home > threads && G != 1)) {
      std::printf("n_home %%d: G %%d, want %%d\n", n_home, G, want);
      return 1;
    }
    for (int t = 0; t < threads; ++t) {
      const Lane L = lane_of(n_home, threads, t);
      if (L.G != G || L.s < 0 || L.s >= G || t != stripe_lane(L.h, L.s, G)) {
        std::printf("n_home %%d lane %%d: (%%d, %%d, %%d)\n", n_home, t, L.h,
                    L.s, L.G);
        return 1;
      }
    }
    for (int h = 0; h < n_home; ++h) {
      // the reduction: stripe 0's lane adds the others' sums onto its own
      std::vector<int> order;
      order.push_back(stripe_lane(h, 0, G));
      reduce_stripes(h, G, [&](int t) { order.push_back(t); });
      if (static_cast<int>(order.size()) != G) {
        std::printf("n_home %%d: home %%d reduces %%zu stripes\n", n_home, h,
                    order.size());
        return 1;
      }
      for (int s = 0; s < G; ++s) {
        const int t = order[s];
        const Lane L = lane_of(n_home, threads, t);
        if (t < 0 || t >= threads || L.h != h || L.s != s) {
          std::printf("n_home %%d: home %%d stripe %%d read from lane %%d\n",
                      n_home, h, s, t);
          return 1;
        }
      }
    }
    for (const int n : rows) {
      std::vector<int> seen(static_cast<size_t>(n_home) * n, 0);
      for (int t = 0; t < threads; ++t) {
        const Lane L = lane_of(n_home, threads, t);
        if (L.h >= n_home) continue;
        for (int jj = L.s; jj < n; jj += L.G) {
          ++seen[static_cast<size_t>(L.h) * n + jj];
          ++walked;
        }
      }
      for (size_t k = 0; k < seen.size(); ++k)
        if (seen[k] != 1) {
          std::printf("n_home %%d, %%d rows: home %%zu row %%zu walked %%d "
                      "times\n", n_home, n, k / n, k %% n, seen[k]);
          return 1;
        }
    }
  }
  std::printf("%%ld\n", walked);
  return 0;
}
"""


@pytest.fixture(scope="module")
def lane_check(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no host g++ to compile the engine's lane map")
    d = tmp_path_factory.mktemp("lanes")
    cpp = d / "lanes.cpp"
    cpp.write_text("\n".join([
        '#include "cell_pair_host_shim.h"', f'#include "{CG.ENGINE}"',
        LANE_CHECK % {"rows": ", ".join(map(str, ROWS))}]))
    exe = d / "lanes"
    subprocess.run(["g++", "-O2", "-std=c++17", "-Wall",
                    "-Wno-unknown-pragmas", "-Wno-unused-function",
                    f"-I{TESTS}", "-o", str(exe), str(cpp)], check=True,
                   capture_output=True, text=True)
    return exe


@pytest.mark.parametrize("threads", THREADS)
def test_lane_map_walks_every_pair_once(lane_check, threads):
    run = subprocess.run([str(lane_check), str(threads)],
                         capture_output=True, text=True)
    assert run.returncode == 0, run.stdout + run.stderr
    # every (home, row) pair of every home count and row count, once
    want = sum(n_home * n for n_home in range(1, threads + 1) for n in ROWS)
    assert int(run.stdout) == want


@pytest.mark.parametrize("threads", THREADS)
def test_python_stripes_match_the_engine(lane_check, threads):
    run = subprocess.run([str(lane_check), str(threads), "stripes"],
                         capture_output=True, text=True, check=True)
    want = [int(g) for g in run.stdout.split()]
    assert len(want) == threads
    assert TCP.stripes(torch.arange(1, threads + 1), threads).tolist() == want
    assert [TCP.stripes(n, threads) for n in range(1, threads + 1)] == want
