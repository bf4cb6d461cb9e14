// Native host runtime for fastlivo_tpu_torch (a copy of
// fastlivo_tpu/native/src/livo_host.cc, built by fastlivo_tpu_torch.native).
//
// The reference's runtime is C++ end-to-end (ROS callbacks, PCL filters,
// buffer plumbing — reference: src/preprocess.cpp, laser_mapping.cpp
// callbacks :809-943). The port keeps the compute path on the GPU but the
// host-side data plane is native too:
//
//  - measurement-log codec: the bag replacement. One sequential binary
//    stream of IMU / LiDAR / image records; this module indexes and
//    decodes it at memory bandwidth (the Python struct fallback is ~50x
//    slower on scan-heavy logs).
//  - voxel filtering: hash-set voxel masking used by the host back-end.
//
// Plain C ABI (extern "C") consumed via ctypes — no pybind11 dependency.
//
// Log format (little endian):
//   header:  magic "FLVO" (4 bytes), u32 version (=1)
//   records: u8 type; then
//     type 0 (imu):   f64 stamp, f64 gyr[3], f64 acc[3]
//     type 1 (lidar): f64 stamp, u32 n, n * { f32 x, y, z, t_ms, inten }
//     type 2 (image): f64 stamp, u32 h, u32 w, h*w u8 gray
//
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_set>
#include <vector>

extern "C" {

struct RecordIndex {
  uint8_t type;
  uint64_t offset;   // offset of the payload (after the type byte)
  double stamp;
  uint32_t count;    // lidar: points; image: h<<16|w; imu: 0
};

// First pass: index the stream. Returns the number of records, or -1 on a
// malformed stream. `index_out` may be null to only count.
int64_t flvo_index(const uint8_t* buf, uint64_t len, RecordIndex* index_out,
                   uint64_t max_records) {
  if (len < 8 || std::memcmp(buf, "FLVO", 4) != 0) return -1;
  uint32_t version;
  std::memcpy(&version, buf + 4, 4);
  if (version != 1) return -1;

  uint64_t off = 8;
  int64_t n = 0;
  while (off < len) {
    uint8_t type = buf[off];
    uint64_t payload = off + 1;
    if (payload + 8 > len) return -1;
    double stamp;
    std::memcpy(&stamp, buf + payload, 8);
    uint32_t count = 0;
    uint64_t size = 0;
    switch (type) {
      case 0:  // imu
        size = 8 + 6 * 8;
        break;
      case 1: {  // lidar
        if (payload + 12 > len) return -1;
        std::memcpy(&count, buf + payload + 8, 4);
        size = 12 + (uint64_t)count * 5 * 4;
        break;
      }
      case 2: {  // image
        if (payload + 16 > len) return -1;
        uint32_t h, w;
        std::memcpy(&h, buf + payload + 8, 4);
        std::memcpy(&w, buf + payload + 12, 4);
        count = (h << 16) | w;
        size = 16 + (uint64_t)h * w;
        break;
      }
      default:
        return -1;
    }
    if (payload + size > len) return -1;
    if (index_out && (uint64_t)n < max_records) {
      index_out[n].type = type;
      index_out[n].offset = payload;
      index_out[n].stamp = stamp;
      index_out[n].count = count;
    }
    off = payload + size;
    n++;
  }
  return n;
}

// Decode one LiDAR record (payload offset from the index) into caller
// buffers, applying blind/max-range gates and `filter_num` decimation.
// Returns the number of points kept.
int64_t flvo_decode_lidar(const uint8_t* buf, uint64_t payload_off,
                          float blind, float max_range, int32_t filter_num,
                          float* xyz_out, float* t_ms_out, float* inten_out) {
  uint32_t n;
  std::memcpy(&n, buf + payload_off + 8, 4);
  const uint8_t* p = buf + payload_off + 12;
  const float blind2 = blind * blind;
  const float max2 = max_range * max_range;
  int64_t kept = 0;
  for (uint32_t i = 0; i < n; i++) {
    float rec[5];
    std::memcpy(rec, p + (uint64_t)i * 20, 20);
    if (filter_num > 1 && (i % filter_num) != 0) continue;
    const float r2 = rec[0] * rec[0] + rec[1] * rec[1];
    if (!(r2 > blind2 && r2 < max2)) continue;
    if (!(rec[0] == rec[0] && rec[1] == rec[1] && rec[2] == rec[2])) continue;
    xyz_out[kept * 3 + 0] = rec[0];
    xyz_out[kept * 3 + 1] = rec[1];
    xyz_out[kept * 3 + 2] = rec[2];
    t_ms_out[kept] = rec[3];
    if (inten_out) inten_out[kept] = rec[4];
    kept++;
  }
  return kept;
}

// Decode one IMU record.
void flvo_decode_imu(const uint8_t* buf, uint64_t payload_off, double* gyr,
                     double* acc) {
  std::memcpy(gyr, buf + payload_off + 8, 24);
  std::memcpy(acc, buf + payload_off + 32, 24);
}

// Decode one image record into an h*w u8 buffer.
void flvo_decode_image(const uint8_t* buf, uint64_t payload_off,
                       uint8_t* out) {
  uint32_t h, w;
  std::memcpy(&h, buf + payload_off + 8, 4);
  std::memcpy(&w, buf + payload_off + 12, 4);
  std::memcpy(out, buf + payload_off + 16, (uint64_t)h * w);
}

// Voxel mask: marks the FIRST point in each voxel (hash-set pass).
// Returns the number of selected points; sets mask_out[i] in {0,1}.
int64_t flvo_voxel_mask(const float* pts, int64_t n, float leaf,
                        uint8_t* mask_out) {
  std::unordered_set<uint64_t> seen;
  seen.reserve((size_t)n);
  const float inv = 1.0f / leaf;
  int64_t kept = 0;
  for (int64_t i = 0; i < n; i++) {
    const int64_t x = (int64_t)std::floor(pts[i * 3 + 0] * inv);
    const int64_t y = (int64_t)std::floor(pts[i * 3 + 1] * inv);
    const int64_t z = (int64_t)std::floor(pts[i * 3 + 2] * inv);
    const uint64_t key = ((uint64_t)(x & 0x1FFFFF) << 42) |
                         ((uint64_t)(y & 0x1FFFFF) << 21) |
                         ((uint64_t)(z & 0x1FFFFF));
    if (seen.insert(key).second) {
      mask_out[i] = 1;
      kept++;
    } else {
      mask_out[i] = 0;
    }
  }
  return kept;
}

}  // extern "C"
