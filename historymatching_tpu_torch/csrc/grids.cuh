// The grids the hand kernels are instantiated for: the flagship 64x64, the
// 20x20 EnOpt case, and 16x16 and 32x32 for tests. Each kernel is a
// template on (NX, NY), so every loop bound and neighbour offset is a
// compile-time constant; the C entries refuse a grid outside the list.
// Kernel K's strip body is compiled for any other grid whose strips fit one
// block into a library of its own (HM_KRT_*, transport_upwind.cu); kernel P
// is compiled for any other grid with a hierarchy into a library of its
// own, with HM_GRID_NX and HM_GRID_NY defined (ops/_build.py). The Python
// mirror of this list is ops/_build.py GRIDS.
#pragma once

#ifndef HM_GRID_NX
#define HM_FOR_GRIDS(F) F(16, 16) F(20, 20) F(32, 32) F(64, 64)
#else
#define HM_FOR_GRIDS(F) F(HM_GRID_NX, HM_GRID_NY)
#endif
