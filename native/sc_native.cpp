// scx native runtime components.
//
// The reference implements its data plane in C++ (tools/shared/world_format.cpp
// sector codec, mesh import, the streaming workers); this library is the
// engine's equivalent: a fast sector-file codec and procedural
// spawn baker exposed through a plain C ABI (loaded from Python via ctypes).
// The hot host path — sector IO + bake into SoA arrays during streaming —
// runs here; array math on device stays in XLA/Pallas.
//
// Formats are bit-identical to the reference (magic SECT v4, chunked
// INST/LANE/SPWN/COLL records, record-size probing on read).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr uint32_t kSectorMagic = 0x54434553;  // "SECT"
constexpr uint32_t kInstanceNameMax = 64;

constexpr uint32_t kInst = 0x54534E49;  // "INST"
constexpr uint32_t kLane = 0x454E414C;  // "LANE"
constexpr uint32_t kSpwn = 0x4E575053;  // "SPWN"
constexpr uint32_t kColl = 0x4C4C4F43;  // "COLL"

// lowbias32 / FNV-1a: the engine-wide deterministic hash chain
uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

uint32_t hash_coord_seed(uint32_t seed, int32_t x, int32_t z) {
  uint32_t h = seed;
  h ^= mix32(static_cast<uint32_t>(x) * 73856093u);
  h ^= mix32(static_cast<uint32_t>(z) * 19349663u);
  return mix32(h + 0x9e3779b9u);
}

float rand01(uint32_t& s) {
  s = mix32(s + 0x6d2b79f5u);
  return static_cast<float>(s & 0x00FFFFFFu) / 16777215.0f;
}

float lerp(float a, float b, float t) { return a + (b - a) * t; }

struct Reader {
  const uint8_t* p;
  size_t n;
  size_t off = 0;
  bool ok = true;

  template <typename T>
  T read() {
    T v{};
    if (off + sizeof(T) > n) {
      ok = false;
      return v;
    }
    std::memcpy(&v, p + off, sizeof(T));
    off += sizeof(T);
    return v;
  }

  void skip(size_t k) {
    if (off + k > n) {
      ok = false;
      return;
    }
    off += k;
  }
};

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Hashing (bit-compatible with scx.core.prng)
// ---------------------------------------------------------------------------

uint32_t scn_mix32(uint32_t x) { return mix32(x); }

uint32_t scn_hash_coord_seed(uint32_t seed, int32_t x, int32_t z) {
  return hash_coord_seed(seed, x, z);
}

uint64_t scn_fnv1a64(const char* text) {
  uint64_t h = 1469598103934665603ull;
  for (const unsigned char* c = reinterpret_cast<const unsigned char*>(text); *c;
       ++c) {
    h ^= static_cast<uint64_t>(*c);
    h *= 1099511628211ull;
  }
  return h;
}

// ---------------------------------------------------------------------------
// Sector codec: parse the instance chunk of a .scsector buffer directly into
// SoA arrays (the streaming bake path).  Caller provides capacity; returns
// the instance count (or -1 on malformed input).
// out_transforms: [cap, 9] (pos3, rot3, scale3)
// out_ids:        [cap, 4] u64 (instance id, model, mesh, material)
// ---------------------------------------------------------------------------

int32_t scn_parse_sector_instances(const uint8_t* data, uint64_t size,
                                   int32_t* out_coord,  // [2]
                                   float* out_transforms, uint64_t* out_ids,
                                   int32_t cap) {
  Reader r{data, static_cast<size_t>(size)};
  if (r.read<uint32_t>() != kSectorMagic) return -1;
  const uint32_t version = r.read<uint32_t>();
  out_coord[0] = r.read<int32_t>();
  out_coord[1] = r.read<int32_t>();

  int32_t count_out = 0;
  while (r.ok && r.off < r.n) {
    const uint32_t cid = r.read<uint32_t>();
    const uint32_t csize = r.read<uint32_t>();
    if (!r.ok) break;
    if (csize == 0) continue;
    if (cid != kInst) {
      r.skip(csize);
      continue;
    }
    const uint32_t count = r.read<uint32_t>();
    const uint32_t base_v3 = 8 + 8 + 8 + 36 + 4;
    const uint32_t base_v4 = base_v3 + 8;
    uint32_t rec = base_v3;
    if (count > 0 && csize >= 4) rec = (csize - 4) / count;
    const bool has_model = version >= 4;
    const uint32_t base = has_model ? base_v4 : base_v3;
    const bool has_name = rec >= base + kInstanceNameMax;
    const uint32_t base_n = base + (has_name ? kInstanceNameMax : 0);
    const bool has_over = rec >= base_n + 12;
    const uint32_t expected = base_n + (has_over ? 12u : 0u);

    for (uint32_t i = 0; i < count && r.ok; ++i) {
      const uint64_t id = r.read<uint64_t>();
      const uint64_t model = has_model ? r.read<uint64_t>() : 0;
      const uint64_t meshid = r.read<uint64_t>();
      const uint64_t material = r.read<uint64_t>();
      float tr[9];
      for (float& v : tr) v = r.read<float>();
      if (has_name) r.skip(kInstanceNameMax);
      r.read<uint32_t>();  // tags
      if (has_over) {
        r.read<uint64_t>();  // albedo override
        r.read<uint32_t>();  // material flags
      }
      if (rec > expected) r.skip(rec - expected);
      if (count_out < cap) {
        std::memcpy(out_transforms + count_out * 9, tr, sizeof(tr));
        uint64_t* ids = out_ids + count_out * 4;
        ids[0] = id;
        ids[1] = model;
        ids[2] = meshid;
        ids[3] = material;
        ++count_out;
      }
    }
  }
  return r.ok || count_out > 0 ? count_out : -1;
}

// ---------------------------------------------------------------------------
// Procedural spawn baking (bit-compatible with the reference generator and
// scx.world.procgen) straight into SoA arrays.
// out_transforms: [cap, 9]; out_kind: [cap] (0 = ground, 1..3 material class
// checker/test/unlit in low bits, bit 4 set = triangle mesh)
// ---------------------------------------------------------------------------

int32_t scn_generate_sector_spawns(uint32_t seed, int32_t sx, int32_t sz,
                                   float sector_size, uint32_t props_min,
                                   uint32_t props_max, int32_t ground_plane,
                                   float* out_transforms, int32_t* out_kind,
                                   int32_t cap) {
  const float size = sector_size;
  const float min_x = static_cast<float>(sx) * size;
  const float min_z = static_cast<float>(sz) * size;

  uint32_t rng = hash_coord_seed(seed, sx, sz);
  const uint32_t range = props_max - props_min + 1u;
  const uint32_t prop_count = props_min + (range > 0 ? (mix32(rng) % range) : 0u);

  int32_t n = 0;
  if (ground_plane && n < cap) {
    float* t = out_transforms + n * 9;
    t[0] = min_x + size * 0.5f;
    t[1] = -0.55f;
    t[2] = min_z + size * 0.5f;
    t[3] = t[4] = t[5] = 0.0f;
    t[6] = size;
    t[7] = 0.10f;
    t[8] = size;
    out_kind[n] = 0;
    ++n;
  }

  const float pad = 1.0f;
  for (uint32_t i = 0; i < prop_count && n < cap; ++i) {
    const float x = lerp(min_x + pad, min_x + size - pad, rand01(rng));
    const float z = lerp(min_z + pad, min_z + size - pad, rand01(rng));
    const float sxx = lerp(0.4f, 1.9f, rand01(rng));
    const float syy = lerp(0.5f, 3.2f, rand01(rng));
    const float szz = lerp(0.4f, 1.9f, rand01(rng));
    const float ry = rand01(rng) * (3.1415926535f * 2.0f);
    const float m = rand01(rng);
    const int mat = (m < 0.40f) ? 1 : ((m < 0.80f) ? 2 : 3);
    const int tri = (rand01(rng) < 0.90f) ? 0 : 1;
    float* t = out_transforms + n * 9;
    t[0] = x;
    t[1] = syy * 0.5f;
    t[2] = z;
    t[3] = 0.0f;
    t[4] = ry;
    t[5] = 0.0f;
    t[6] = sxx;
    t[7] = syy;
    t[8] = szz;
    out_kind[n] = mat | (tri << 4);
    ++n;
  }
  return n;
}

}  // extern "C"
