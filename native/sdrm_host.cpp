// sdrm_host — native host-side runtime for sdrmodem.
//
// The reference implements its hot host loops in C with libvolk
// (type conversions, src/sdr/plutosdr.c:63-133) and hand-rolled
// pthread queues (src/queue.c).  In this build the device does the
// math, but the host ingest/egress path still moves and converts
// megabytes per second; this library provides those pieces natively:
//
//  - int16 <-> float32 IQ conversion with saturation + rint semantics
//    (volk_16i_s32f_convert_32f / volk_32f_s32f_convert_16i analogs)
//  - float32 -> int8 soft-symbol conversion (volk_32f_s32f_convert_8i)
//  - MSB-first byte -> NRZ(+-1.0f) expansion (gfsk_mod bit unpack)
//  - a fixed-capacity SPSC ring buffer of sample blocks with blocking
//    and lossy modes + poison pill (queue.c analog)
//
// C ABI only; loaded from Python with ctypes (no pybind11 dependency).

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// conversions

void sdrm_int16_to_float(const int16_t *in, float *out, size_t n, float scale) {
    const float inv = 1.0f / scale;
    for (size_t i = 0; i < n; ++i) {
        out[i] = static_cast<float>(in[i]) * inv;
    }
}

void sdrm_float_to_int16(const float *in, int16_t *out, size_t n, float scale) {
    for (size_t i = 0; i < n; ++i) {
        float v = in[i] * scale;
        if (v > 32767.0f) v = 32767.0f;
        if (v < -32768.0f) v = -32768.0f;
        out[i] = static_cast<int16_t>(v);
    }
}

void sdrm_float_to_int8(const float *in, int8_t *out, size_t n, float scale) {
    for (size_t i = 0; i < n; ++i) {
        float v = in[i] * scale;
        if (v > 127.0f) v = 127.0f;
        if (v < -128.0f) v = -128.0f;
        out[i] = static_cast<int8_t>(::rintf(v));
    }
}

void sdrm_bytes_to_nrz(const uint8_t *in, float *out, size_t n_bytes) {
    for (size_t i = 0; i < n_bytes; ++i) {
        const uint8_t b = in[i];
        for (int j = 0; j < 8; ++j) {
            out[i * 8 + j] = ((b >> (7 - j)) & 1) ? 1.0f : -1.0f;
        }
    }
}

// deinterleave I/Q int16 stream into planar float32 (pluto RX fast path)
void sdrm_iq_int16_to_planar_float(const int16_t *in, float *out_i, float *out_q,
                                   size_t n_samples, float scale) {
    const float inv = 1.0f / scale;
    for (size_t i = 0; i < n_samples; ++i) {
        out_i[i] = static_cast<float>(in[2 * i]) * inv;
        out_q[i] = static_cast<float>(in[2 * i + 1]) * inv;
    }
}

// ---------------------------------------------------------------------------
// SPSC block queue (queue.c analog)

struct SdrmQueue {
    explicit SdrmQueue(size_t capacity, size_t block_bytes, bool blocking)
        : capacity_(capacity), block_bytes_(block_bytes), blocking_(blocking),
          sizes_(capacity, 0), storage_(capacity * block_bytes) {}

    size_t capacity_;
    size_t block_bytes_;
    bool blocking_;
    size_t head_ = 0;  // next to take
    size_t count_ = 0;
    bool interrupted_ = false;
    uint64_t dropped_ = 0;
    std::vector<size_t> sizes_;
    std::vector<uint8_t> storage_;
    std::mutex mu_;
    std::condition_variable cv_put_;
    std::condition_variable cv_take_;

    uint8_t *slot(size_t idx) { return storage_.data() + idx * block_bytes_; }
};

void *sdrm_queue_create(size_t capacity, size_t block_bytes, int blocking) {
    return new SdrmQueue(capacity, block_bytes, blocking != 0);
}

void sdrm_queue_destroy(void *q) { delete static_cast<SdrmQueue *>(q); }

// returns 0 on success, -1 when interrupted
int sdrm_queue_put(void *qp, const uint8_t *data, size_t nbytes) {
    auto *q = static_cast<SdrmQueue *>(qp);
    std::unique_lock<std::mutex> lock(q->mu_);
    if (nbytes > q->block_bytes_) return -2;
    if (q->blocking_) {
        q->cv_put_.wait(lock, [&] { return q->count_ < q->capacity_ || q->interrupted_; });
        if (q->interrupted_) return -1;
    } else if (q->count_ == q->capacity_) {
        // lossy: overwrite the most recently queued block (queue.c:124-128)
        const size_t last = (q->head_ + q->count_ - 1) % q->capacity_;
        std::memcpy(q->slot(last), data, nbytes);
        q->sizes_[last] = nbytes;
        q->dropped_++;
        q->cv_take_.notify_one();
        return 0;
    }
    if (q->interrupted_) return -1;
    const size_t idx = (q->head_ + q->count_) % q->capacity_;
    std::memcpy(q->slot(idx), data, nbytes);
    q->sizes_[idx] = nbytes;
    q->count_++;
    q->cv_take_.notify_one();
    return 0;
}

// blocks; returns bytes copied, 0 on poison pill
int64_t sdrm_queue_take(void *qp, uint8_t *out, size_t out_capacity) {
    auto *q = static_cast<SdrmQueue *>(qp);
    std::unique_lock<std::mutex> lock(q->mu_);
    q->cv_take_.wait(lock, [&] { return q->count_ > 0 || q->interrupted_; });
    if (q->count_ == 0 && q->interrupted_) return 0;
    const size_t idx = q->head_;
    const size_t n = q->sizes_[idx];
    if (n > out_capacity) return -2;
    std::memcpy(out, q->slot(idx), n);
    q->head_ = (q->head_ + 1) % q->capacity_;
    q->count_--;
    q->cv_put_.notify_one();
    return static_cast<int64_t>(n);
}

void sdrm_queue_interrupt(void *qp) {
    auto *q = static_cast<SdrmQueue *>(qp);
    std::lock_guard<std::mutex> lock(q->mu_);
    q->interrupted_ = true;
    q->cv_take_.notify_all();
    q->cv_put_.notify_all();
}

uint64_t sdrm_queue_dropped(void *qp) {
    auto *q = static_cast<SdrmQueue *>(qp);
    std::lock_guard<std::mutex> lock(q->mu_);
    return q->dropped_;
}

}  // extern "C"
