// Tile geometry shared by the flash-attention kernels for Hopper (sm_90a);
// their building blocks (TMA, mbarriers, wgmma) are in hopper.cuh.
#pragma once

namespace kf_flash {

constexpr int BM = 64;             // query rows per tile
constexpr int BN = 64;             // key rows per tile
constexpr float NEG_INF = -1e30f;  // the JAX kernel's mask value

}  // namespace kf_flash
