// C ABI shim over the reference decoder (/root/reference), used ONLY by the
// differential test suite to validate the framework's codecs and
// container parser bit-exactly against the original implementation.
// Compiled out-of-tree against the read-only reference sources; none of the
// reference code is vendored into this repository.

#include <motioncam/RawData.hpp>

#include <cstdint>
#include <cstddef>

extern "C" {

// Returns number of uint16 values written (0 on failure), like raw::Decode.
size_t ref_decode(uint16_t* output, int width, int height,
                  const uint8_t* input, size_t len) {
  return motioncam::raw::Decode(output, width, height, input, len);
}

size_t ref_decode_legacy(uint16_t* output, int width, int height,
                         const uint8_t* input, size_t len) {
  return motioncam::raw::DecodeLegacy(output, width, height, input, len);
}

}  // extern "C"
