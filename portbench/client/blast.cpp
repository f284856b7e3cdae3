/*
 * blast: the benchmark's UDP DNS load client.
 *
 * A rewrite of native/loadgen/dnsblast.cpp (commit 0ba68a39) for a
 * measured window.  It differs from that client in four ways:
 *   - it runs for a duration (-d), not for a fixed number of queries;
 *   - it has a closed loop (-m closed, -w queries in flight) and a
 *     paced open loop (-m open: each query is sent at its due time,
 *     read from the schedule, whatever the server does);
 *   - every query is timed from its due time (open loop) or its first
 *     send (closed loop) to its first reply, retransmissions included,
 *     and a query never answered is reported as such;
 *   - the replies of the queries the schedule marks are kept for the
 *     benchmark's reference check.
 *
 * Usage:
 *   blast -p PORT [-H ADDR] -t TEMPLATES -q SCHEDULE -a SOURCES
 *         -m open|closed [-w INFLIGHT] -d SECONDS [-r RETRY_S]
 *         [-g GRACE_S] [-P PROCS -I INDEX] -o OUT_PREFIX
 *
 * TEMPLATES holds length-prefixed (u16, big endian) DNS query wires; the
 * 2-byte id is rewritten per query.  SCHEDULE holds packed records
 * {f64 due_s, u32 template, u32 source, u32 flags}: due_s is the offset
 * of the query's due time from the window's start (open loop only),
 * source an index into SOURCES (one IPv4 address a line, each bound by
 * its own socket), flags bit 0 keeps the reply.  This process takes the
 * records whose index is INDEX modulo PROCS; a closed loop cycles
 * through them.
 *
 * Once its sockets are bound it prints "ready" and reads one line
 * "go <t0>" from stdin: t0 is the window's start on CLOCK_MONOTONIC.
 * Queries are sent in [t0, t0 + SECONDS); a query unanswered for
 * RETRY_S is sent again with the same id from the same socket, until it
 * is answered or t0 + SECONDS + GRACE_S passes.  OUT_PREFIX.rec gets one
 * packed record per query sent (see struct Rec), OUT_PREFIX.rep the
 * kept replies, and stdout one JSON line of totals.
 */

#include <arpa/inet.h>
#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <netinet/in.h>
#include <sys/epoll.h>
#include <sys/resource.h>
#include <sys/socket.h>
#include <sys/syscall.h>
#include <time.h>
#include <unistd.h>

#include <algorithm>
#include <deque>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

double now_s() {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (double)ts.tv_sec + (double)ts.tv_nsec * 1e-9;
}

[[noreturn]] void die(const char *msg) {
    perror(msg);
    exit(1);
}

[[noreturn]] void fail(const char *msg) {
    fprintf(stderr, "blast: %s\n", msg);
    exit(1);
}

#pragma pack(push, 1)
struct Entry {
    double due;
    uint32_t tmpl;
    uint32_t source;
    uint32_t flags;
};

/* One query sent; read by portbench/harness/client.py (REC_DTYPE). */
struct Rec {
    uint32_t entry;      /* index into the whole schedule */
    uint16_t retries;    /* sends after the first */
    uint8_t answered;
    uint8_t rcode;
    uint8_t tc;
    uint8_t qmatch;      /* the reply's question is the query's */
    uint16_t reply_len;
    double t_due;        /* open: due time; closed: first send */
    double t_sent;       /* first send */
    double t_reply;      /* first reply, 0 when none */
    uint64_t reply_off;  /* into .rep; UINT64_MAX when not kept */
};
#pragma pack(pop)

std::string read_file(const char *path) {
    FILE *f = fopen(path, "rb");
    if (f == nullptr) die(path);
    std::string out;
    char buf[1 << 16];
    size_t got;
    while ((got = fread(buf, 1, sizeof buf, f)) > 0) out.append(buf, got);
    fclose(f);
    return out;
}

std::vector<std::string> load_templates(const char *path) {
    std::string data = read_file(path);
    std::vector<std::string> out;
    size_t off = 0;
    while (off < data.size()) {
        if (data.size() - off < 2) fail("truncated template file");
        size_t len = ((size_t)(unsigned char)data[off] << 8)
                     | (unsigned char)data[off + 1];
        off += 2;
        if (len < 12 || data.size() - off < len) fail("bad template");
        out.push_back(data.substr(off, len));
        off += len;
    }
    if (out.empty()) fail("no templates");
    return out;
}

/* The question section of a query wire: from byte 12 to the end. */
bool question_matches(const std::string &query, const unsigned char *rep,
                      size_t len) {
    size_t qlen = query.size() - 12;
    if (len < 12 + qlen) return false;
    return memcmp(query.data() + 12, rep + 12, qlen) == 0;
}

struct Query {
    size_t rec;          /* index into recs */
    double last_send;
};

}  // namespace

int main(int argc, char **argv) {
    int port = 0, inflight = 64, procs = 1, index = 0;
    const char *host = "127.0.0.1", *tpath = nullptr, *qpath = nullptr;
    const char *apath = nullptr, *out = nullptr, *mode = "open";
    double seconds = 0.0, retry_s = 1.0, grace_s = 60.0;
    int opt;
    while ((opt = getopt(argc, argv, "p:H:t:q:a:m:w:d:r:g:P:I:o:")) != -1) {
        switch (opt) {
        case 'p': port = atoi(optarg); break;
        case 'H': host = optarg; break;
        case 't': tpath = optarg; break;
        case 'q': qpath = optarg; break;
        case 'a': apath = optarg; break;
        case 'm': mode = optarg; break;
        case 'w': inflight = atoi(optarg); break;
        case 'd': seconds = atof(optarg); break;
        case 'r': retry_s = atof(optarg); break;
        case 'g': grace_s = atof(optarg); break;
        case 'P': procs = atoi(optarg); break;
        case 'I': index = atoi(optarg); break;
        case 'o': out = optarg; break;
        default: fail("bad option");
        }
    }
    bool open_loop = strcmp(mode, "open") == 0;
    if (!open_loop && strcmp(mode, "closed") != 0) fail("-m open|closed");
    if (port <= 0 || !tpath || !qpath || !apath || !out || seconds <= 0
            || procs < 1 || index < 0 || index >= procs || inflight < 1
            || retry_s <= 0)
        fail("usage: see the header of blast.cpp");

    std::vector<std::string> templates = load_templates(tpath);
    std::string sched = read_file(qpath);
    if (sched.size() % sizeof(Entry) != 0) fail("bad schedule size");
    size_t n_all = sched.size() / sizeof(Entry);
    std::vector<Entry> entries;
    std::vector<uint32_t> entry_index;
    for (size_t i = (size_t)index; i < n_all; i += (size_t)procs) {
        Entry e;
        memcpy(&e, sched.data() + i * sizeof(Entry), sizeof(Entry));
        if (e.tmpl >= templates.size()) fail("template out of range");
        entries.push_back(e);
        entry_index.push_back((uint32_t)i);
    }
    if (entries.empty()) fail("no schedule entries for this process");

    /* one socket per source address that this process uses */
    std::vector<std::string> sources;
    {
        std::string text = read_file(apath);
        size_t off = 0;
        while (off < text.size()) {
            size_t nl = text.find('\n', off);
            if (nl == std::string::npos) nl = text.size();
            if (nl > off) sources.push_back(text.substr(off, nl - off));
            off = nl + 1;
        }
    }
    struct sockaddr_in dst{};
    dst.sin_family = AF_INET;
    dst.sin_port = htons((uint16_t)port);
    if (inet_pton(AF_INET, host, &dst.sin_addr) != 1) fail("bad -H");
    int ep = epoll_create1(0);
    if (ep < 0) die("epoll_create1");
    std::vector<int> fds(sources.size(), -1);
    std::unordered_map<int, uint32_t> fd_source;
    for (const Entry &e : entries) {
        if (e.source >= sources.size()) fail("source out of range");
        if (fds[e.source] >= 0) continue;
        int fd = socket(AF_INET, SOCK_DGRAM | SOCK_NONBLOCK, 0);
        if (fd < 0) die("socket");
        int rcvbuf = 1 << 20;
        (void)setsockopt(fd, SOL_SOCKET, SO_RCVBUF, &rcvbuf, sizeof rcvbuf);
        struct sockaddr_in src{};
        src.sin_family = AF_INET;
        if (inet_pton(AF_INET, sources[e.source].c_str(),
                      &src.sin_addr) != 1)
            fail("bad source address");
        if (bind(fd, (struct sockaddr *)&src, sizeof src) != 0)
            die("bind source");
        if (connect(fd, (struct sockaddr *)&dst, sizeof dst) != 0)
            die("connect");
        struct epoll_event ev{};
        ev.events = EPOLLIN;
        ev.data.u32 = e.source;
        if (epoll_ctl(ep, EPOLL_CTL_ADD, fd, &ev) != 0) die("epoll_ctl");
        fds[e.source] = fd;
        fd_source[fd] = e.source;
    }

    printf("ready\n");
    fflush(stdout);
    char line[128];
    if (fgets(line, sizeof line, stdin) == nullptr
            || strncmp(line, "go ", 3) != 0)
        fail("expected 'go <t0>' on stdin");
    double t0 = atof(line + 3);
    double t_end = t0 + seconds, t_stop = t_end + grace_s;
    for (double wait = t0 - now_s(); wait > 0; wait = t0 - now_s()) {
        struct timespec ts;
        ts.tv_sec = (time_t)wait;
        ts.tv_nsec = (long)((wait - (double)ts.tv_sec) * 1e9);
        nanosleep(&ts, nullptr);
    }

    std::string rep_path = std::string(out) + ".rep";
    FILE *rep = fopen(rep_path.c_str(), "wb");
    if (rep == nullptr) die("open .rep");
    uint64_t rep_off = 0;

    std::vector<Rec> recs;
    recs.reserve(open_loop ? entries.size() : (size_t)1 << 20);
    std::vector<std::string> wires;   /* the wire of each rec, id set */
    wires.reserve(recs.capacity());
    std::vector<uint32_t> rec_k;      /* this process's entry of each rec */
    rec_k.reserve(recs.capacity());
    /* (source << 16 | id) -> rec, for queries not yet answered */
    std::unordered_map<uint64_t, size_t> waiting;
    std::deque<Query> fifo;           /* in order of last send */
    std::vector<uint16_t> next_id(sources.size(), 0);
    size_t next = 0, outstanding = 0;
    long sends = 0, send_errors = 0, late_n = 0;
    double late_sum = 0.0, late_max = 0.0;

    auto start_query = [&](size_t k, double due, double now) {
        const Entry &e = entries[k];
        uint16_t id = next_id[e.source]++;
        std::string w = templates[e.tmpl];
        w[0] = (char)(id >> 8);
        w[1] = (char)(id & 0xff);
        Rec rc{};
        rc.entry = entry_index[k];
        rc.t_due = due;
        rc.t_sent = now;
        rc.reply_off = UINT64_MAX;
        recs.push_back(rc);
        rec_k.push_back((uint32_t)k);
        wires.push_back(std::move(w));
        size_t r = recs.size() - 1;
        if (send(fds[e.source], wires[r].data(), wires[r].size(), 0) < 0)
            send_errors++;
        sends++;
        uint64_t key = ((uint64_t)e.source << 16) | id;
        waiting[key] = r;
        fifo.push_back(Query{r, now});
        outstanding++;
        double late = now - due;
        if (open_loop) {
            late_sum += late;
            late_n++;
            if (late > late_max) late_max = late;
        }
    };

    std::vector<struct epoll_event> events(512);
    unsigned char buf[65536];
    bool have_pwait2 = true;
    size_t cursor = 0;                /* closed loop: next entry */
    while (true) {
        double now = now_s();
        if (now < t_end) {
            if (open_loop) {
                while (next < entries.size() && t0 + entries[next].due <= now
                       && t0 + entries[next].due < t_end) {
                    start_query(next, t0 + entries[next].due, now);
                    next++;
                }
            } else {
                while (outstanding < (size_t)inflight) {
                    size_t k = cursor++ % entries.size();
                    start_query(k, now, now);
                }
            }
        }
        while (!fifo.empty()) {
            Query &q = fifo.front();
            Rec &rc = recs[q.rec];
            if (rc.answered) {
                fifo.pop_front();
                continue;
            }
            if (q.last_send + retry_s > now || now >= t_stop) break;
            size_t r = q.rec;
            fifo.pop_front();
            if (send(fds[entries[rec_k[r]].source], wires[r].data(), wires[r].size(),
                     0) < 0)
                send_errors++;
            sends++;
            rc.retries++;
            fifo.push_back(Query{r, now});
        }
        bool sending = now < t_end
                       && (!open_loop || next < entries.size());
        if (!sending && (outstanding == 0 || now >= t_stop)) break;

        /* wait for replies until the next due send (open loop), the
         * next retransmission, or 1 ms */
        double wake = now + 1e-3;
        if (open_loop && sending && next < entries.size())
            wake = std::min(wake, t0 + entries[next].due);
        double wait = wake - now;
        int n;
        if (wait <= 0) {
            n = epoll_wait(ep, events.data(), (int)events.size(), 0);
        } else if (have_pwait2) {
            struct timespec ts;
            ts.tv_sec = 0;
            ts.tv_nsec = (long)(wait * 1e9);
            n = (int)syscall(SYS_epoll_pwait2, ep, events.data(),
                             (int)events.size(), &ts, nullptr, 0);
            if (n < 0 && errno == ENOSYS) {
                have_pwait2 = false;
                n = 0;
            }
        } else {
            /* no ns timeout: poll without sleeping while a send is due
             * within the millisecond */
            n = epoll_wait(ep, events.data(), (int)events.size(),
                           wait >= 1e-3 ? 1 : 0);
        }
        if (n < 0) {
            if (errno == EINTR) continue;
            die("epoll_wait");
        }
        for (int i = 0; i < n; i++) {
            uint32_t s = events[(size_t)i].data.u32;
            int fd = fds[s];
            while (true) {
                ssize_t got = recv(fd, buf, sizeof buf, 0);
                if (got < 0) {
                    if (errno == EAGAIN || errno == EWOULDBLOCK) break;
                    if (errno == EINTR || errno == ECONNREFUSED) continue;
                    die("recv");
                }
                double t = now_s();
                if (got < 12) continue;
                uint16_t id = (uint16_t)((buf[0] << 8) | buf[1]);
                auto it = waiting.find(((uint64_t)s << 16) | id);
                if (it == waiting.end()) continue;   /* a late duplicate */
                size_t r = it->second;
                waiting.erase(it);
                Rec &rc = recs[r];
                rc.answered = 1;
                rc.t_reply = t;
                rc.rcode = buf[3] & 0x0f;
                rc.tc = (buf[2] >> 1) & 1;
                rc.qmatch = question_matches(wires[r], buf, (size_t)got);
                rc.reply_len = (uint16_t)got;
                outstanding--;
                if (entries[rec_k[r]].flags & 1) {
                    if (fwrite(buf, 1, (size_t)got, rep) != (size_t)got)
                        die("write .rep");
                    rc.reply_off = rep_off;
                    rep_off += (uint64_t)got;
                }
            }
        }
    }
    double t_done = now_s();
    if (fclose(rep) != 0) die("close .rep");
    std::string rec_path = std::string(out) + ".rec";
    FILE *rf = fopen(rec_path.c_str(), "wb");
    if (rf == nullptr) die("open .rec");
    if (!recs.empty()
            && fwrite(recs.data(), sizeof(Rec), recs.size(), rf)
               != recs.size())
        die("write .rec");
    if (fclose(rf) != 0) die("close .rec");
    for (int fd : fds)
        if (fd >= 0) close(fd);

    struct rusage ru;
    getrusage(RUSAGE_SELF, &ru);
    double cpu = (double)ru.ru_utime.tv_sec + ru.ru_utime.tv_usec * 1e-6
                 + (double)ru.ru_stime.tv_sec + ru.ru_stime.tv_usec * 1e-6;
    printf("{\"queries\": %zu, \"sends\": %ld, \"send_errors\": %ld, "
           "\"unanswered\": %zu, \"late_mean_s\": %.9f, "
           "\"late_max_s\": %.9f, \"cpu_s\": %.6f, \"wall_s\": %.6f, "
           "\"sockets\": %zu, \"pwait2\": %s}\n",
           recs.size(), sends, send_errors, outstanding,
           late_n ? late_sum / (double)late_n : 0.0, late_max, cpu,
           t_done - t0, fd_source.size(), have_pwait2 ? "true" : "false");
    return 0;
}
