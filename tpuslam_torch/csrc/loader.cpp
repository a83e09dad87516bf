// Native stereo-frame prefetch loader.
//
// TPU-native re-design of the reference's data-movement runtime: the
// CameraStereoImages file reader (src/slam/src/core/CameraStereoImages.cpp)
// plus the double-banked DDR buffer scheme the A53 consumed from
// (FPGA.h:35-53 bank map, FPGA.cpp:251-347 receiveData, bank toggling
// xusb_main.c:202-206).  Decoder threads fill a ring of frame banks ahead
// of the consumer; the Python side maps each ready bank zero-copy, uploads
// to the TPU, and releases it — IO/decode overlaps device compute exactly
// the way the PL pipeline overlapped the CPU back-end.
//
// Decodes 8-bit grayscale PNG (color types 0 and 2, all filter types,
// via zlib) and binary PGM (P5).  C ABI for ctypes.
//
// Build: g++ -O3 -shared -fPIC loader.cpp -o _native_loader.so -lz -lpthread

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

struct Image {
  int width = 0;
  int height = 0;
  std::vector<uint8_t> pixels;  // grayscale
};

// ---------------------------------------------------------------- PNG --
uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = p > a ? p - a : a - p;
  int pb = p > b ? p - b : b - p;
  int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

bool decode_png(const std::vector<uint8_t>& data, Image* out) {
  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (data.size() < 8 || memcmp(data.data(), sig, 8) != 0) return false;

  size_t pos = 8;
  int width = 0, height = 0, bit_depth = 0, color_type = 0, interlace = 0;
  std::vector<uint8_t> idat;
  while (pos + 8 <= data.size()) {
    uint32_t len = be32(&data[pos]);
    if (pos + 12 + len > data.size()) return false;
    const char* type = reinterpret_cast<const char*>(&data[pos + 4]);
    const uint8_t* body = &data[pos + 8];
    if (!memcmp(type, "IHDR", 4)) {
      width = be32(body);
      height = be32(body + 4);
      bit_depth = body[8];
      color_type = body[9];
      interlace = body[12];
    } else if (!memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), body, body + len);
    } else if (!memcmp(type, "IEND", 4)) {
      break;
    }
    pos += 12 + len;
  }
  if (width <= 0 || height <= 0 || bit_depth != 8 || interlace != 0)
    return false;
  int channels;
  switch (color_type) {
    case 0: channels = 1; break;  // gray
    case 2: channels = 3; break;  // rgb
    case 4: channels = 2; break;  // gray+alpha
    case 6: channels = 4; break;  // rgba
    default: return false;
  }

  const size_t stride = size_t(width) * channels;
  std::vector<uint8_t> raw((stride + 1) * height);
  uLongf raw_len = raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK ||
      raw_len != raw.size())
    return false;

  // unfilter in place into `img`
  std::vector<uint8_t> img(stride * height);
  const int bpp = channels;
  for (int y = 0; y < height; y++) {
    const uint8_t* src = &raw[size_t(y) * (stride + 1)];
    uint8_t filter = src[0];
    src++;
    uint8_t* dst = &img[size_t(y) * stride];
    const uint8_t* up = y > 0 ? &img[size_t(y - 1) * stride] : nullptr;
    for (size_t x = 0; x < stride; x++) {
      int a = x >= size_t(bpp) ? dst[x - bpp] : 0;
      int b = up ? up[x] : 0;
      int c = (up && x >= size_t(bpp)) ? up[x - bpp] : 0;
      int v = src[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default: return false;
      }
      dst[x] = uint8_t(v);
    }
  }

  out->width = width;
  out->height = height;
  out->pixels.resize(size_t(width) * height);
  if (channels == 1) {
    out->pixels = std::move(img);
  } else {
    // ITU-R BT.601 luma, matching PIL convert("L") integer rounding
    for (size_t i = 0, n = size_t(width) * height; i < n; i++) {
      const uint8_t* p = &img[i * channels];
      if (channels >= 3) {
        out->pixels[i] =
            uint8_t((p[0] * 299 + p[1] * 587 + p[2] * 114 + 500) / 1000);
      } else {  // gray+alpha
        out->pixels[i] = p[0];
      }
    }
  }
  return true;
}

// ---------------------------------------------------------------- PGM --
bool decode_pgm(const std::vector<uint8_t>& data, Image* out) {
  if (data.size() < 2 || data[0] != 'P' || data[1] != '5') return false;
  size_t pos = 2;
  auto next_int = [&](int* v) -> bool {
    // skip whitespace and comments
    while (pos < data.size()) {
      if (data[pos] == '#') {
        while (pos < data.size() && data[pos] != '\n') pos++;
      } else if (isspace(data[pos])) {
        pos++;
      } else {
        break;
      }
    }
    int r = 0;
    bool any = false;
    while (pos < data.size() && isdigit(data[pos])) {
      r = r * 10 + (data[pos] - '0');
      pos++;
      any = true;
    }
    *v = r;
    return any;
  };
  int w, h, maxval;
  if (!next_int(&w) || !next_int(&h) || !next_int(&maxval)) return false;
  if (maxval != 255) return false;
  pos++;  // single whitespace after maxval
  if (pos + size_t(w) * h > data.size()) return false;
  out->width = w;
  out->height = h;
  out->pixels.assign(&data[pos], &data[pos] + size_t(w) * h);
  return true;
}

bool read_file(const std::string& path, std::vector<uint8_t>* out) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  out->resize(n);
  bool ok = fread(out->data(), 1, n, f) == size_t(n);
  fclose(f);
  return ok;
}

bool decode_file(const std::string& path, Image* out) {
  std::vector<uint8_t> data;
  if (!read_file(path, &data)) return false;
  if (decode_png(data, out)) return true;
  return decode_pgm(data, out);
}

// ------------------------------------------------------------- loader --
enum BankState { EMPTY, FILLING, READY, IN_USE };

struct Bank {
  BankState state = EMPTY;
  int frame = -1;
  Image left, right;
  bool ok = false;
};

struct Loader {
  std::vector<std::string> left_paths, right_paths;
  std::vector<Bank> banks;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_ready;   // consumer waits for next frame
  std::condition_variable cv_free;    // workers wait for a free bank
  int next_to_fill = 0;    // next frame index a worker should claim
  int next_to_serve = 0;   // next frame index the consumer wants
  bool stop = false;
};

void worker_main(Loader* L) {
  for (;;) {
    int frame = -1;
    Bank* bank = nullptr;
    {
      std::unique_lock<std::mutex> lk(L->mu);
      for (;;) {
        if (L->stop || L->next_to_fill >= int(L->left_paths.size()))
          return;
        // claim the next frame only if a bank is free AND the frame is
        // within the ring window (avoids filling far ahead of serving)
        for (auto& b : L->banks) {
          if (b.state == EMPTY &&
              L->next_to_fill <
                  L->next_to_serve + int(L->banks.size())) {
            bank = &b;
            break;
          }
        }
        if (bank) break;
        L->cv_free.wait(lk);
      }
      frame = L->next_to_fill++;
      bank->state = FILLING;
      bank->frame = frame;
    }
    bank->ok = decode_file(L->left_paths[frame], &bank->left) &&
               decode_file(L->right_paths[frame], &bank->right);
    {
      std::lock_guard<std::mutex> lk(L->mu);
      bank->state = READY;
    }
    L->cv_ready.notify_all();
  }
}

}  // namespace

extern "C" {

// paths: '\n'-joined left paths, then right paths; counts must match.
void* tsl_open(const char* left_blob, const char* right_blob, int n_banks,
               int n_threads) {
  auto split = [](const char* blob) {
    std::vector<std::string> out;
    const char* p = blob;
    while (*p) {
      const char* e = strchr(p, '\n');
      if (!e) {
        out.emplace_back(p);
        break;
      }
      out.emplace_back(p, e - p);
      p = e + 1;
    }
    return out;
  };
  Loader* L = new Loader();
  L->left_paths = split(left_blob);
  L->right_paths = split(right_blob);
  if (L->left_paths.size() != L->right_paths.size() ||
      L->left_paths.empty()) {
    delete L;
    return nullptr;
  }
  if (n_banks < 2) n_banks = 2;
  if (n_threads < 1) n_threads = 1;
  L->banks.resize(n_banks);
  for (int i = 0; i < n_threads; i++)
    L->workers.emplace_back(worker_main, L);
  return L;
}

int tsl_count(void* h) {
  return int(static_cast<Loader*>(h)->left_paths.size());
}

// Blocks until the next frame (in order) is decoded.  Returns the bank
// id (>= 0), or -1 at end of sequence, or -2 on decode failure.
// Outputs zero-copy pointers into the bank.
int tsl_next(void* h, const uint8_t** left, const uint8_t** right,
             int* width, int* height) {
  Loader* L = static_cast<Loader*>(h);
  std::unique_lock<std::mutex> lk(L->mu);
  if (L->next_to_serve >= int(L->left_paths.size())) return -1;
  int want = L->next_to_serve;
  Bank* bank = nullptr;
  for (;;) {
    for (auto& b : L->banks) {
      if (b.state == READY && b.frame == want) {
        bank = &b;
        break;
      }
    }
    if (bank) break;
    L->cv_ready.wait(lk);
  }
  L->next_to_serve++;
  bank->state = IN_USE;
  if (!bank->ok) {
    bank->state = EMPTY;
    L->cv_free.notify_all();
    return -2;
  }
  *left = bank->left.pixels.data();
  *right = bank->right.pixels.data();
  *width = bank->left.width;
  *height = bank->left.height;
  return int(bank - L->banks.data());
}

// Release a bank returned by tsl_next once its pixels were consumed.
void tsl_release(void* h, int bank_id) {
  Loader* L = static_cast<Loader*>(h);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    if (bank_id >= 0 && bank_id < int(L->banks.size()))
      L->banks[bank_id].state = EMPTY;
  }
  L->cv_free.notify_all();
}

void tsl_close(void* h) {
  Loader* L = static_cast<Loader*>(h);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->stop = true;
  }
  L->cv_free.notify_all();
  L->cv_ready.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

// Standalone single-image decode (used by tests / simple callers).
int tsl_decode(const char* path, uint8_t* out, int capacity, int* width,
               int* height) {
  Image img;
  if (!decode_file(path, &img)) return -1;
  int n = img.width * img.height;
  if (n > capacity) return -2;
  memcpy(out, img.pixels.data(), n);
  *width = img.width;
  *height = img.height;
  return n;
}

}  // extern "C"
