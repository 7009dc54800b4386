// MPEG-TS demuxer, C++ twin of jsmpeg_tpu_torch/demux.py (semantics of the
// reference demuxer, jsmpeg/src/ts.js): 188-byte packets, resync
// needing 5 aligned sync bytes, PID -> stream-id learning from PES start
// codes, 33-bit PTS in seconds, PES reassembly with two completion
// signals (declared packet length, padded-packet heuristic), leftover
// carry between writes.
//
// ABI: ts_demux_write/flush serialize completed PES packets into the
// caller's output buffer as events:
//   { u32 stream_id; u32 payload_len; f64 pts; u8 payload[payload_len]; }
// (16-byte header, packed little-endian; events are back to back).
// Returns the number of bytes written, or -1 if the buffer is too small.
// Callers must size the buffer from ts_demux_pending() + the input length
// + event headers (see NativeTSDemux._cap); on overflow the demux state
// keeps every undelivered payload, so a flush with a larger buffer still
// recovers the data (event boundaries, not bytes, may differ).

#include <cstdint>
#include <cstring>
#include <map>
#include <vector>

namespace {

constexpr int kPacket = 188;

struct PesState {
    int64_t total_length = 0;
    std::vector<uint8_t> payload;
    double pts = 0.0;
};

struct Emitter {
    uint8_t* out;
    int64_t cap;
    int64_t off = 0;
    bool overflow = false;

    bool emit(uint32_t stream_id, const PesState& ps) {
        int64_t need = 16 + (int64_t)ps.payload.size();
        if (off + need > cap) { overflow = true; return false; }
        uint32_t len = (uint32_t)ps.payload.size();
        std::memcpy(out + off, &stream_id, 4);
        std::memcpy(out + off + 4, &len, 4);
        std::memcpy(out + off + 8, &ps.pts, 8);
        if (len) std::memcpy(out + off + 16, ps.payload.data(), len);
        off += need;
        return true;
    }
};

struct TsDemux {
    bool guess_video_frame_end = true;
    std::map<int, int> pid_to_stream;
    std::map<int, PesState> pes;           // connected stream ids only
    std::vector<int> connect_order;        // flush order = connect order
    std::vector<uint8_t> leftover;
    double start_time = 0.0;
    double current_time = 0.0;
    int64_t packets_parsed = 0;
    int64_t resyncs = 0;

    void complete(int stream_id, PesState& ps, Emitter& em) {
        // on overflow the payload stays buffered: a later flush with a
        // larger buffer still delivers it
        if (em.emit((uint32_t)stream_id, ps)) {
            ps.total_length = 0;
            ps.payload.clear();
        }
    }

    // returns the position after the packet, or -1 to stop (keep leftover
    // from `pos`)
    int64_t parse_packet(const uint8_t* d, int64_t n, int64_t pos,
                         Emitter& em) {
        if (d[pos] != 0x47) {
            int64_t s = resync(d, n, pos);
            if (s == -1) return -1;
            // -2: garbage skip of 187 bytes -- like the Python twin, the
            // bytes there are then parsed as a packet without re-checking
            // the sync byte (demux.py _resync returning pos + 187)
            pos = (s == -2) ? pos + kPacket - 1 : s;
        }
        int64_t end = pos + kPacket;
        packets_parsed++;

        int b1 = d[pos + 1];
        bool payload_start = (b1 & 0x40) != 0;
        int pid = ((b1 & 0x1F) << 8) | d[pos + 2];
        int adaptation = (d[pos + 3] >> 4) & 0x3;
        int64_t p = pos + 4;

        int stream_id = -1;
        auto it = pid_to_stream.find(pid);
        if (it != pid_to_stream.end()) stream_id = it->second;
        if (payload_start && stream_id >= 0) {
            auto pi = pes.find(stream_id);
            if (pi != pes.end() && !pi->second.payload.empty())
                complete(stream_id, pi->second, em);
        }

        if (adaptation & 0x1) {
            if (adaptation & 0x2) {
                int af_len = d[p];
                p += 1 + af_len;
                if (p >= end) return end;
            }
            if (payload_start && p + 3 < end && d[p] == 0 && d[p + 1] == 0
                    && d[p + 2] == 1 && p + 9 <= n) {
                stream_id = d[p + 3];
                pid_to_stream[pid] = stream_id;
                int64_t packet_length = (d[p + 4] << 8) | d[p + 5];
                int pts_dts = (d[p + 7] >> 6) & 0x3;
                int header_length = d[p + 8];
                int64_t payload_begin = p + 9 + header_length;
                auto pi = pes.find(stream_id);
                if (pi != pes.end()) {
                    double pts = 0.0;
                    if ((pts_dts & 0x2) && p + 14 <= n) {
                        const uint8_t* q = d + p + 9;
                        int64_t p32_30 = (q[0] >> 1) & 0x7;
                        int64_t p29_15 = (q[1] << 7) | (q[2] >> 1);
                        int64_t p14_0 = (q[3] << 7) | (q[4] >> 1);
                        pts = (double)(p32_30 * 1073741824LL
                                       + p29_15 * 32768LL + p14_0) / 90000.0;
                        current_time = pts;
                        if (start_time == -1.0) start_time = pts;
                    }
                    int64_t payload_length =
                        packet_length ? packet_length - header_length - 3
                                      : 0;
                    pi->second.total_length = payload_length;
                    pi->second.payload.clear();
                    pi->second.pts = pts;
                }
                p = payload_begin;
            }

            if (stream_id >= 0) {
                auto pi = pes.find(stream_id);
                if (pi != pes.end() && p < end) {
                    PesState& ps = pi->second;
                    ps.payload.insert(ps.payload.end(), d + p, d + end);
                    bool complete_now =
                        ps.total_length != 0
                        && (int64_t)ps.payload.size() >= ps.total_length;
                    bool has_padding = !payload_start && (adaptation & 0x2);
                    if (complete_now
                            || (guess_video_frame_end && has_padding))
                        complete(stream_id, ps, em);
                }
            }
        }
        return end;
    }

    // mirror of demux.py _resync: needs 5 aligned sync bytes within 6
    // packets of lookahead; -1 = stop and keep leftover
    int64_t resync(const uint8_t* d, int64_t n, int64_t pos) {
        if (n - pos < kPacket * 6) return -1;
        for (int i = 0; i < kPacket - 1; i++) {
            if (d[pos + i] == 0x47) {
                bool ok = true;
                for (int j = 1; j < 5; j++)
                    if (d[pos + i + kPacket * j] != 0x47) { ok = false;
                                                            break; }
                if (ok) { resyncs++; return pos + i; }
            }
        }
        resyncs++;
        if (n - (pos + kPacket - 1) < kPacket) return -1;
        return -2;  // skip 187 bytes of garbage, continue
    }

    int64_t write(const uint8_t* chunk, int64_t len, uint8_t* out,
                  int64_t cap) {
        std::vector<uint8_t> data;
        data.reserve(leftover.size() + len);
        data.insert(data.end(), leftover.begin(), leftover.end());
        data.insert(data.end(), chunk, chunk + len);
        Emitter em{out, cap};
        int64_t pos = 0;
        int64_t n = (int64_t)data.size();
        while (n - pos >= kPacket) {
            int64_t next = parse_packet(data.data(), n, pos, em);
            if (next < 0) break;
            pos = next;
        }
        leftover.assign(data.begin() + pos, data.end());
        return em.overflow ? -1 : em.off;
    }

    int64_t flush(uint8_t* out, int64_t cap) {
        Emitter em{out, cap};
        for (int sid : connect_order) {
            auto it = pes.find(sid);
            if (it != pes.end() && !it->second.payload.empty())
                complete(sid, it->second, em);
        }
        return em.overflow ? -1 : em.off;
    }
};

}  // namespace

extern "C" {

void* ts_demux_create(int guess_video_frame_end) {
    TsDemux* d = new TsDemux();
    d->guess_video_frame_end = guess_video_frame_end != 0;
    return d;
}

void ts_demux_destroy(void* h) { delete (TsDemux*)h; }

void ts_demux_connect(void* h, int stream_id) {
    TsDemux* d = (TsDemux*)h;
    // reset like the Python twin's connect() (replaces the PES slot,
    // dropping any partial payload)
    auto it = d->pes.find(stream_id);
    if (it == d->pes.end()) d->connect_order.push_back(stream_id);
    d->pes[stream_id] = PesState();
}

long long ts_demux_write(void* h, const uint8_t* data, long long len,
                         uint8_t* out, long long cap) {
    return ((TsDemux*)h)->write(data, len, out, cap);
}

long long ts_demux_flush(void* h, uint8_t* out, long long cap) {
    return ((TsDemux*)h)->flush(out, cap);
}

// upper bound on bytes the NEXT write/flush may emit beyond its input:
// accumulated PES payloads + leftover (event headers are bounded by the
// caller from the packet count)
long long ts_demux_pending(void* h) {
    TsDemux* d = (TsDemux*)h;
    long long total = (long long)d->leftover.size();
    for (auto& kv : d->pes) total += (long long)kv.second.payload.size();
    return total;
}

double ts_demux_current_time(void* h) { return ((TsDemux*)h)->current_time; }
double ts_demux_start_time(void* h) { return ((TsDemux*)h)->start_time; }
long long ts_demux_packets(void* h) { return ((TsDemux*)h)->packets_parsed; }
long long ts_demux_resyncs(void* h) { return ((TsDemux*)h)->resyncs; }

}  // extern "C"
