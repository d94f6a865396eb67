// Native OBJ parser — the framework's data-loader hot path.
//
// The port's own copy of the JAX package's parser (csrc/objloader.cpp at the
// repository root), the same code, built with g++ at first use by
// tpu_raytracing_torch/scene/native_loader.py.
//
// The reference's asset pipeline is native C++ (src/FileIO.cpp): a custom
// tokenizer feeding fan triangulation.  This loader covers the same grammar
// (v/vt/vn/f with negative and 1-based indices, n-gon fans around corner 0,
// mtllib/usemtl, '#' comments) but is a brand-new implementation designed
// around a single read + single pass over a memory buffer, emitting flat
// arrays that the Python layer turns into SoA arrays without copies.
//
// Material resolution stays in Python (MTL + texture decode need PIL); the
// parser reports the mtllib path and the per-face usemtl name slot.
//
// C ABI (ctypes): obj_parse() fills an ObjMesh with malloc'd arrays;
// obj_free() releases them.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

struct ObjMesh {
    float* vertices;   // [num_vertices * 3]
    float* uvs;        // [num_uvs * 2]
    float* normals;    // [num_normals * 3]
    int32_t* face_idx; // [num_tris * 9] — (v,t,n) per corner, -1 = missing
    int32_t* face_mat; // [num_tris] — slot into usemtl name list, -1 = none
    char* names;       // '\0'-separated: mtllib path, then usemtl names
    int64_t num_vertices;
    int64_t num_uvs;
    int64_t num_normals;
    int64_t num_tris;
    int64_t num_names;   // count of usemtl names (mtllib excluded)
    int64_t names_bytes; // total size of the names blob
};

}  // extern "C"

namespace {

inline const char* skip_ws(const char* p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) p++;
    return p;
}

inline const char* next_line(const char* p, const char* end) {
    while (p < end && *p != '\n') p++;
    return p < end ? p + 1 : end;
}

// Minimal fast float parse (OBJ floats are plain decimal, optional exponent).
inline float parse_float(const char*& p, const char* end) {
    char* out;
    float v = strtof(p, &out);
    p = out > end ? end : out;
    return v;
}

inline long parse_int(const char*& p, const char* end) {
    char* out;
    long v = strtol(p, &out, 10);
    p = out > end ? end : out;
    return v;
}

struct Corner {
    int32_t v, t, n;
};

inline int32_t resolve(long f, int64_t count) {
    if (f == 0) return -1;
    return f < 0 ? (int32_t)(f + count) : (int32_t)(f - 1);
}

}  // namespace

extern "C" int obj_parse(const char* path, ObjMesh* mesh) {
    memset(mesh, 0, sizeof(*mesh));
    FILE* fp = fopen(path, "rb");
    if (!fp) return -1;
    fseek(fp, 0, SEEK_END);
    long size = ftell(fp);
    fseek(fp, 0, SEEK_SET);
    std::vector<char> buf((size_t)size + 1);
    if (size > 0 && fread(buf.data(), 1, (size_t)size, fp) != (size_t)size) {
        fclose(fp);
        return -2;
    }
    fclose(fp);
    buf[(size_t)size] = '\0';

    std::vector<float> verts, uvs, normals;
    std::vector<int32_t> face_idx, face_mat;
    std::vector<Corner> corners;
    std::string names;   // mtllib first (may be empty), then usemtl names
    std::string mtllib;
    std::vector<std::string> mat_names;
    int32_t current_mat = -1;

    verts.reserve(300000);
    face_idx.reserve(900000);

    const char* p = buf.data();
    const char* end = buf.data() + size;

    while (p < end) {
        p = skip_ws(p, end);
        const char* line_end = p;
        while (line_end < end && *line_end != '\n') line_end++;

        if (p + 1 < end && p[0] == 'v' && (p[1] == ' ' || p[1] == '\t')) {
            p += 2;
            p = skip_ws(p, end);
            float x = parse_float(p, line_end);
            float y = parse_float(p, line_end);
            float z = parse_float(p, line_end);
            verts.push_back(x);
            verts.push_back(y);
            verts.push_back(z);
        } else if (p + 2 < end && p[0] == 'v' && p[1] == 't' &&
                   (p[2] == ' ' || p[2] == '\t')) {
            p += 3;
            float u = parse_float(p, line_end);
            float v = parse_float(p, line_end);
            uvs.push_back(u);
            uvs.push_back(v);
        } else if (p + 2 < end && p[0] == 'v' && p[1] == 'n' &&
                   (p[2] == ' ' || p[2] == '\t')) {
            p += 3;
            float x = parse_float(p, line_end);
            float y = parse_float(p, line_end);
            float z = parse_float(p, line_end);
            normals.push_back(x);
            normals.push_back(y);
            normals.push_back(z);
        } else if (p + 1 < end && p[0] == 'f' && (p[1] == ' ' || p[1] == '\t')) {
            p += 2;
            corners.clear();
            int64_t nv = (int64_t)verts.size() / 3;
            int64_t nt = (int64_t)uvs.size() / 2;
            int64_t nn = (int64_t)normals.size() / 3;
            while (true) {
                p = skip_ws(p, line_end);
                if (p >= line_end || *p == '\n') break;
                Corner c = {-1, -1, -1};
                c.v = resolve(parse_int(p, line_end), nv);
                if (p < line_end && *p == '/') {
                    p++;
                    if (p < line_end && *p != '/') c.t = resolve(parse_int(p, line_end), nt);
                    if (p < line_end && *p == '/') {
                        p++;
                        c.n = resolve(parse_int(p, line_end), nn);
                    }
                }
                corners.push_back(c);
                if (p >= line_end) break;
            }
            // Fan triangulation around corner 0 (FileIO.cpp:405-432 grammar).
            for (size_t i = 2; i < corners.size(); i++) {
                const Corner tri[3] = {corners[0], corners[i - 1], corners[i]};
                for (int k = 0; k < 3; k++) {
                    face_idx.push_back(tri[k].v);
                    face_idx.push_back(tri[k].t);
                    face_idx.push_back(tri[k].n);
                }
                face_mat.push_back(current_mat);
            }
        } else if (line_end - p > 7 && memcmp(p, "mtllib", 6) == 0) {
            const char* q = skip_ws(p + 6, line_end);
            const char* e = q;
            while (e < line_end && *e != ' ' && *e != '\t' && *e != '\r') e++;
            mtllib.assign(q, (size_t)(e - q));
        } else if (line_end - p > 7 && memcmp(p, "usemtl", 6) == 0) {
            const char* q = skip_ws(p + 6, line_end);
            const char* e = q;
            while (e < line_end && *e != ' ' && *e != '\t' && *e != '\r') e++;
            std::string name(q, (size_t)(e - q));
            int32_t slot = -1;
            for (size_t i = 0; i < mat_names.size(); i++) {
                if (mat_names[i] == name) {
                    slot = (int32_t)i;
                    break;
                }
            }
            if (slot < 0) {
                slot = (int32_t)mat_names.size();
                mat_names.push_back(name);
            }
            current_mat = slot;
        }
        p = next_line(line_end, end);
    }

    names = mtllib;
    names.push_back('\0');
    for (const auto& n : mat_names) {
        names += n;
        names.push_back('\0');
    }

    auto dup = [](const void* src, size_t bytes) -> void* {
        void* out = malloc(bytes ? bytes : 1);
        if (out && bytes) memcpy(out, src, bytes);
        return out;
    };

    mesh->vertices = (float*)dup(verts.data(), verts.size() * sizeof(float));
    mesh->uvs = (float*)dup(uvs.data(), uvs.size() * sizeof(float));
    mesh->normals = (float*)dup(normals.data(), normals.size() * sizeof(float));
    mesh->face_idx = (int32_t*)dup(face_idx.data(), face_idx.size() * sizeof(int32_t));
    mesh->face_mat = (int32_t*)dup(face_mat.data(), face_mat.size() * sizeof(int32_t));
    mesh->names = (char*)dup(names.data(), names.size());
    mesh->num_vertices = (int64_t)verts.size() / 3;
    mesh->num_uvs = (int64_t)uvs.size() / 2;
    mesh->num_normals = (int64_t)normals.size() / 3;
    mesh->num_tris = (int64_t)face_mat.size();
    mesh->num_names = (int64_t)mat_names.size();
    mesh->names_bytes = (int64_t)names.size();
    return 0;
}

extern "C" void obj_free(ObjMesh* mesh) {
    free(mesh->vertices);
    free(mesh->uvs);
    free(mesh->normals);
    free(mesh->face_idx);
    free(mesh->face_mat);
    free(mesh->names);
    memset(mesh, 0, sizeof(*mesh));
}
