// The grids the hand kernels are instantiated for: the flagship 64x64, the
// 20x20 EnOpt case, and 16x16 and 32x32 for tests. Each kernel is a
// template on (NX, NY), so every loop bound and neighbour offset is a
// compile-time constant; a grid outside this list is refused by the C
// entries and, before them, by the Python wrappers (ops/_build.py GRIDS).
#pragma once

#define HM_FOR_GRIDS(F) F(16, 16) F(20, 20) F(32, 32) F(64, 64)
