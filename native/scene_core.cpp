// scene_core: native CSG scene-graph arena + tape compiler (C ABI).
//
// This framework's counterpart of the reference's native scene component
// (renderer.c:176-202, 2220-2313): parallel node tables in one arena, a
// non-root bitset, and — the part the reference never built — a postfix-tape
// compiler with root-to-leaf transform composition done in double precision.
//
// Exposed as a plain C ABI consumed from Python via ctypes
// (csgrenderer/scene/native.py). The Python SceneGraph is the behavioral
// spec; tests assert tape-for-tape parity between the two implementations.
//
// Build: make -C native   (produces libcsgr_scene.so)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum NodeType : int32_t {
  SPHERE = 0,
  INFINITE_PLANAR_PARTITION = 1,
  BOX = 2,
  CYLINDER = 3,
  UNION_OF = 4,
  INTERSECTION_OF = 5,
  DIFFERENCE_OF = 6,
};

enum Opcode : int32_t {
  OP_PUSH = 0,
  OP_UNION = 1,
  OP_INTERSECT = 2,
  OP_DIFF = 3,
};

struct Quat {
  double w = 1, x = 0, y = 0, z = 0;
};

struct Vec3 {
  double x = 0, y = 0, z = 0;
};

Quat qmul(const Quat& a, const Quat& b) {
  return Quat{
      a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z,
      a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
      a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
      a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w,
  };
}

Quat qconj(const Quat& q) { return Quat{q.w, -q.x, -q.y, -q.z}; }

Vec3 qrotate(const Quat& q, const Vec3& v) {
  // v + 2*cross(u, cross(u, v) + w*v), u = (x,y,z)
  const double ux = q.x, uy = q.y, uz = q.z, w = q.w;
  const double tx = 2.0 * (uy * v.z - uz * v.y);
  const double ty = 2.0 * (uz * v.x - ux * v.z);
  const double tz = 2.0 * (ux * v.y - uy * v.x);
  return Vec3{
      v.x + w * tx + (uy * tz - uz * ty),
      v.y + w * ty + (uz * tx - ux * tz),
      v.z + w * tz + (ux * ty - uy * tx),
  };
}

struct Edge {
  Quat q;
  Vec3 off;
};

struct NodeInfo {
  // leaves: params[4]; binops: child ids + edge transforms
  double params[4] = {0, 0, 0, 0};
  int32_t left = -1, right = -1;
  Edge left_edge, right_edge;
};

struct Material {
  int32_t kind = 0;
  double albedo[3] = {1, 1, 1};
  double param = 0;
};

struct Scene {
  size_t max_nodes;
  std::vector<int32_t> types;
  std::vector<NodeInfo> infos;
  std::vector<Material> mats;
  std::vector<uint8_t> nonroot;
  int32_t error = 0;  // sticky: 1 = pool exhausted, 2 = bad child id
};

struct CompiledProgram {
  std::vector<int32_t> ops;       // opcode stream
  std::vector<int32_t> operands;  // PUSH leaf index / 0
  std::vector<int32_t> leaf_types;
  std::vector<double> leaf_params;   // [L*4]
  std::vector<double> leaf_rot;      // [L*4] world->local quat (w,x,y,z)
  std::vector<double> leaf_pos;      // [L*3]
  std::vector<int32_t> mat_kind;     // [L]
  std::vector<double> albedo;        // [L*3]
  std::vector<double> mat_param;     // [L]
  std::vector<double> edge_quat;     // [E*4] local->parent
  std::vector<double> edge_off;      // [E*3]
  std::vector<int32_t> chain_offsets;  // [L+1] prefix offsets into chain_edges
  std::vector<int32_t> chain_edges;    // flattened root-to-leaf edge ids
  int32_t stack_depth = 0;
  int32_t error = 0;
};

int32_t allocate(Scene* s, int32_t type, const NodeInfo& info, const Material& m) {
  if (s->types.size() >= s->max_nodes) {
    s->error = 1;
    return -1;
  }
  s->types.push_back(type);
  s->infos.push_back(info);
  s->mats.push_back(m);
  s->nonroot.push_back(0);
  return static_cast<int32_t>(s->types.size()) - 1;
}

bool valid_node(const Scene* s, int32_t id) {
  return id >= 0 && static_cast<size_t>(id) < s->types.size();
}

void walk(const Scene* s, CompiledProgram* p, int32_t node, Quat q_acc,
          Vec3 t_acc, std::vector<int32_t>& chain, int depth) {
  if (depth > 64 || !valid_node(s, node)) {
    p->error = 3;
    return;
  }
  const int32_t type = s->types[node];
  const NodeInfo& info = s->infos[node];
  if (type <= CYLINDER) {  // leaf
    p->leaf_types.push_back(type);
    for (int i = 0; i < 4; i++) p->leaf_params.push_back(info.params[i]);
    const Quat q_wl = qconj(q_acc);
    p->leaf_rot.push_back(q_wl.w);
    p->leaf_rot.push_back(q_wl.x);
    p->leaf_rot.push_back(q_wl.y);
    p->leaf_rot.push_back(q_wl.z);
    p->leaf_pos.push_back(t_acc.x);
    p->leaf_pos.push_back(t_acc.y);
    p->leaf_pos.push_back(t_acc.z);
    const Material& m = s->mats[node];
    p->mat_kind.push_back(m.kind);
    for (int i = 0; i < 3; i++) p->albedo.push_back(m.albedo[i]);
    p->mat_param.push_back(m.param);
    p->chain_offsets.push_back(static_cast<int32_t>(p->chain_edges.size()));
    for (int32_t e : chain) p->chain_edges.push_back(e);
    p->ops.push_back(OP_PUSH);
    p->operands.push_back(static_cast<int32_t>(p->leaf_types.size()) - 1);
    return;
  }
  // binop: record both edges, recurse with composed transforms
  const Edge* edges[2] = {&info.left_edge, &info.right_edge};
  const int32_t children[2] = {info.left, info.right};
  for (int i = 0; i < 2; i++) {
    const Edge& e = *edges[i];
    const int32_t eid = static_cast<int32_t>(p->edge_quat.size() / 4);
    p->edge_quat.push_back(e.q.w);
    p->edge_quat.push_back(e.q.x);
    p->edge_quat.push_back(e.q.y);
    p->edge_quat.push_back(e.q.z);
    p->edge_off.push_back(e.off.x);
    p->edge_off.push_back(e.off.y);
    p->edge_off.push_back(e.off.z);
    const Vec3 rotated = qrotate(q_acc, e.off);
    const Vec3 t_child{t_acc.x + rotated.x, t_acc.y + rotated.y,
                       t_acc.z + rotated.z};
    const Quat q_child = qmul(q_acc, e.q);
    chain.push_back(eid);
    walk(s, p, children[i], q_child, t_child, chain, depth + 1);
    chain.pop_back();
  }
  int32_t op = OP_UNION;
  if (type == INTERSECTION_OF) op = OP_INTERSECT;
  if (type == DIFFERENCE_OF) op = OP_DIFF;
  p->ops.push_back(op);
  p->operands.push_back(0);
}

}  // namespace

extern "C" {

void* csgr_scene_new(int64_t max_nodes) {
  auto* s = new Scene();
  s->max_nodes = static_cast<size_t>(max_nodes);
  return s;
}

void csgr_scene_del(void* h) { delete static_cast<Scene*>(h); }

int32_t csgr_scene_error(void* h) { return static_cast<Scene*>(h)->error; }

int64_t csgr_scene_node_count(void* h) {
  return static_cast<int64_t>(static_cast<Scene*>(h)->types.size());
}

int32_t csgr_add_leaf(void* h, int32_t type, const double* params4,
                      int32_t mat_kind, const double* albedo3,
                      double mat_param) {
  auto* s = static_cast<Scene*>(h);
  NodeInfo info;
  std::memcpy(info.params, params4, 4 * sizeof(double));
  Material m;
  m.kind = mat_kind;
  std::memcpy(m.albedo, albedo3, 3 * sizeof(double));
  m.param = mat_param;
  return allocate(s, type, info, m);
}

int32_t csgr_add_binop(void* h, int32_t type, int32_t left,
                       const double* left_quat4, const double* left_off3,
                       int32_t right, const double* right_quat4,
                       const double* right_off3) {
  auto* s = static_cast<Scene*>(h);
  if (!valid_node(s, left) || !valid_node(s, right)) {
    s->error = 2;
    return -1;
  }
  NodeInfo info;
  info.left = left;
  info.right = right;
  info.left_edge.q = Quat{left_quat4[0], left_quat4[1], left_quat4[2], left_quat4[3]};
  info.left_edge.off = Vec3{left_off3[0], left_off3[1], left_off3[2]};
  info.right_edge.q =
      Quat{right_quat4[0], right_quat4[1], right_quat4[2], right_quat4[3]};
  info.right_edge.off = Vec3{right_off3[0], right_off3[1], right_off3[2]};
  const int32_t id = allocate(s, type, info, Material{});
  if (id >= 0) {
    s->nonroot[left] = 1;
    s->nonroot[right] = 1;
  }
  return id;
}

int32_t csgr_is_root(void* h, int32_t id) {
  auto* s = static_cast<Scene*>(h);
  if (!valid_node(s, id)) return -1;
  return s->nonroot[id] ? 0 : 1;
}

// Two-phase compile: csgr_compile returns a program handle + sizes; the
// caller allocates numpy buffers and calls csgr_program_read to fill them,
// then csgr_program_del.

void* csgr_compile(void* h, int32_t root) {
  auto* s = static_cast<Scene*>(h);
  auto* p = new CompiledProgram();
  if (!valid_node(s, root)) {
    p->error = 2;
    return p;
  }
  std::vector<int32_t> chain;
  walk(s, p, root, Quat{}, Vec3{}, chain, 0);
  p->chain_offsets.push_back(static_cast<int32_t>(p->chain_edges.size()));
  // stack depth
  int32_t depth = 0, max_depth = 0;
  for (int32_t op : p->ops) {
    depth += (op == OP_PUSH) ? 1 : -1;
    if (depth > max_depth) max_depth = depth;
  }
  p->stack_depth = max_depth;
  return p;
}

void csgr_program_sizes(void* ph, int64_t* out6) {
  auto* p = static_cast<CompiledProgram*>(ph);
  out6[0] = static_cast<int64_t>(p->ops.size());
  out6[1] = static_cast<int64_t>(p->leaf_types.size());
  out6[2] = static_cast<int64_t>(p->edge_quat.size() / 4);
  out6[3] = static_cast<int64_t>(p->chain_edges.size());
  out6[4] = p->stack_depth;
  out6[5] = p->error;
}

void csgr_program_read(void* ph, int32_t* ops, int32_t* operands,
                       int32_t* leaf_types, double* leaf_params,
                       double* leaf_rot, double* leaf_pos, int32_t* mat_kind,
                       double* albedo, double* mat_param, double* edge_quat,
                       double* edge_off, int32_t* chain_offsets,
                       int32_t* chain_edges) {
  auto* p = static_cast<CompiledProgram*>(ph);
  auto cpy = [](auto* dst, const auto& src) {
    std::memcpy(dst, src.data(), src.size() * sizeof(src[0]));
  };
  cpy(ops, p->ops);
  cpy(operands, p->operands);
  cpy(leaf_types, p->leaf_types);
  cpy(leaf_params, p->leaf_params);
  cpy(leaf_rot, p->leaf_rot);
  cpy(leaf_pos, p->leaf_pos);
  cpy(mat_kind, p->mat_kind);
  cpy(albedo, p->albedo);
  cpy(mat_param, p->mat_param);
  cpy(edge_quat, p->edge_quat);
  cpy(edge_off, p->edge_off);
  cpy(chain_offsets, p->chain_offsets);
  cpy(chain_edges, p->chain_edges);
}

void csgr_program_del(void* ph) { delete static_cast<CompiledProgram*>(ph); }

}  // extern "C"
