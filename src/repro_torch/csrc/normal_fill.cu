// NumPy's standard-normal stream on the card, bit for bit: the port's
// fills (KNN_fill_fragment, KNN_gen_test, fill_fragment, LR_fill_fragment,
// LR_genpred) draw their O(n d) normals here instead of on the host, and
// the data is NumPy's: Generator.standard_normal of the same PCG64 state.
// No TPU twin: the JAX package draws its fills on the host.
//
// The stream: PCG64 (128-bit LCG, XSL-RR output, step then output) feeds
// NumPy's random_standard_normal, a 256-strip ziggurat.  An attempt (a
// "token") reads one raw draw r: idx = r & 0xff, sign = bit 8, rabs =
// bits 9..60, x = rabs * wi[idx]; rabs < ki[idx] returns x (99%).  Else
// strip 0 goes to the tail, reading pairs of doubles until one is taken
// (1 + 2m draws); any other strip reads one double for the wedge test and
// returns x or nothing (2 draws).  So where the n-th normal starts depends
// on every draw before it.
//
// What bounds it on an H100: integer issue.  A draw is a 128-bit
// multiply-add (four 64-bit products) and a rotate, ~25 integer
// instructions, done twice (summary and write); the writes are 4 or 8
// bytes a normal.  400M normals (a linear-regression pipeline): ~2e10
// integer instructions, ~1.5 ms at the card's 64 IMAD/clk/SM, and 3.2 GB
// written, ~1 ms at 3.35 TB/s.
//
// Design (three launches on the caller's stream, no host sync):
//  * nf_summary: the raw stream is cut into chunks of kChunk draws, a
//    thread a chunk.  The thread jumps its PCG64 state to draw c * kChunk
//    (one A s + C inc per set bit of c, from a table of jumps by kChunk *
//    2^j computed once on the host) and parses the chunk's tokens from
//    entry offset 0 to its end, keeping the normals made, the exit offset
//    (how far the last token reached into the next chunk), and for the
//    first kWindow draws which are token starts and which of those made a
//    normal.  The parses from entry offsets 1 .. kEntries - 1 stop where
//    they meet a token start of the parse from 0 (after a token or two):
//    from there on the two are one parse.  A summary is kEntries words of
//    (normals | exit << 16), 16 bytes a chunk (0.4-0.8% of the output).
//  * nf_resolve, one block: thread t composes the maps entry -> (exit,
//    normals) of a segment of chunks; a warp-shuffle scan, then a scan of
//    the warps' totals, gives each segment its true entry offset and the
//    index of its first normal (the stream starts at a token, offset 0);
//    each thread then walks its segment and writes every chunk's (first
//    normal, entry offset) over its summary.  An entry offset past the
//    summaries' (a tail token ending deep in the next chunk) re-parses
//    that chunk serially, counted in `reparses`.  Should a segment
//    boundary be crossed that way, the scan cannot see past it: the
//    segment entered there, which knows its entry, walks from it and
//    stands in the next round's scan for that entry alone (a flat map),
//    until no segment's entry is unknown.  Both are correctness paths,
//    and rare with kEntries 4: a chunk's exit offset passes 3 only where
//    a tail token that takes a second pair starts in its last draws.  A
//    fill holds at most 2^31 - 1 normals (the counts are 32-bit).
//  * nf_write: a thread a chunk draws its tokens again from its entry
//    offset and puts each normal through the fill's epilogue: float64 as
//    drawn (kind 0; normals past `main` go to `noise`), or
//    float32(centres[labels[row], col] + z) (kind 1, the add in float64
//    then rounded, as the host's .astype(np.float32)).  A thread's normals
//    are consecutive but its warp's are a chunk apart, so each thread
//    stages kStage of them in shared memory and the warp stores every
//    full row as one coalesced run.  The last chunk goes on past its end
//    should the chunks provisioned hold fewer than n normals; no thread
//    writes past n.
// Bit for bit: the arithmetic is NumPy's, operation for operation, with
// __dmul_rn / __dadd_rn where the host build does not contract (a fused
// multiply-add would flip wedge decisions); exp and log1p are CUDA's, so
// a tail normal may differ from the host's libm by an ulp or two.  The
// ziggurat tables below are NumPy's ki_double, wi_double and fi_double,
// word for word (the doubles as their bit patterns; the CPU tests read
// them from this file).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// ki_double
__device__ const unsigned long long kKi[256] = {
    0x000ef33d8025ef6aULL, 0x0000000000000000ULL, 0x000c08be98fbc6a8ULL, 0x000da354fabd8142ULL,
    0x000e51f67ec1eeeaULL, 0x000eb255e9d3f77eULL, 0x000eef4b817ecab9ULL, 0x000f19470afa44aaULL,
    0x000f37ed61ffcb18ULL, 0x000f4f469561255cULL, 0x000f61a5e41ba396ULL, 0x000f707a755396a4ULL,
    0x000f7cb2ec28449aULL, 0x000f86f10c6357d3ULL, 0x000f8fa6578325deULL, 0x000f9724c74dd0daULL,
    0x000f9da907dbf509ULL, 0x000fa360f581fa74ULL, 0x000fa86fde5b4bf8ULL, 0x000facf160d354dcULL,
    0x000fb0fb6718b90fULL, 0x000fb49f8d5374c6ULL, 0x000fb7ec2366fe77ULL, 0x000fbaece9a1e50eULL,
    0x000fbdab9d040bedULL, 0x000fc03060ff6c57ULL, 0x000fc2821037a248ULL, 0x000fc4a67ae25bd1ULL,
    0x000fc6a2977aee31ULL, 0x000fc87aa92896a4ULL, 0x000fca325e4bde85ULL, 0x000fcbcce902231aULL,
    0x000fcd4d12f839c4ULL, 0x000fceb54d8fec99ULL, 0x000fd007bf1dc930ULL, 0x000fd1464dd6c4e6ULL,
    0x000fd272a8e2f450ULL, 0x000fd38e4ff0c91eULL, 0x000fd49a9990b478ULL, 0x000fd598b8920f53ULL,
    0x000fd689c08e99ecULL, 0x000fd76ea9c8e832ULL, 0x000fd848547b08e8ULL, 0x000fd9178bad2c8cULL,
    0x000fd9dd07a7add2ULL, 0x000fda9970105e8cULL, 0x000fdb4d5dc02e20ULL, 0x000fdbf95c5bfcd0ULL,
    0x000fdc9debb99a7dULL, 0x000fdd3b8118729dULL, 0x000fddd288342f90ULL, 0x000fde6364369f64ULL,
    0x000fdeee708d514eULL, 0x000fdf7401a6b42eULL, 0x000fdff46599ed40ULL, 0x000fe06fe4bc24f2ULL,
    0x000fe0e6c225a258ULL, 0x000fe1593c28b84cULL, 0x000fe1c78cbc3f99ULL, 0x000fe231e9db1caaULL,
    0x000fe29885da1b91ULL, 0x000fe2fb8fb54186ULL, 0x000fe35b33558d4aULL, 0x000fe3b799d0002aULL,
    0x000fe410e99ead7fULL, 0x000fe46746d47734ULL, 0x000fe4bad34c095cULL, 0x000fe50baed29524ULL,
    0x000fe559f74ebc78ULL, 0x000fe5a5c8e41212ULL, 0x000fe5ef3e138689ULL, 0x000fe6366fd91078ULL,
    0x000fe67b75c6d578ULL, 0x000fe6be661e11aaULL, 0x000fe6ff55e5f4f2ULL, 0x000fe73e5900a702ULL,
    0x000fe77b823e9e39ULL, 0x000fe7b6e37070a2ULL, 0x000fe7f08d774243ULL, 0x000fe8289053f08cULL,
    0x000fe85efb35173aULL, 0x000fe893dc840864ULL, 0x000fe8c741f0cebcULL, 0x000fe8f9387d4ef6ULL,
    0x000fe929cc879b1dULL, 0x000fe95909d388eaULL, 0x000fe986fb939aa2ULL, 0x000fe9b3ac714866ULL,
    0x000fe9df2694b6d5ULL, 0x000fea0973abe67cULL, 0x000fea329cf166a4ULL, 0x000fea5aab32952cULL,
    0x000fea81a6d5741aULL, 0x000feaa797de1cf0ULL, 0x000feacc85f3d920ULL, 0x000feaf07865e63cULL,
    0x000feb13762fec13ULL, 0x000feb3585fe2a4aULL, 0x000feb56ae3162b4ULL, 0x000feb76f4e284faULL,
    0x000feb965fe62014ULL, 0x000febb4f4cf9d7cULL, 0x000febd2b8f449d0ULL, 0x000febefb16e2e3eULL,
    0x000fec0be31ebde8ULL, 0x000fec2752b15a15ULL, 0x000fec42049dafd3ULL, 0x000fec5bfd29f196ULL,
    0x000fec75406ceef4ULL, 0x000fec8dd2500cb4ULL, 0x000feca5b6911f12ULL, 0x000fecbcf0c427feULL,
    0x000fecd38454fb15ULL, 0x000fece97488c8b3ULL, 0x000fecfec47f91b7ULL, 0x000fed1377358528ULL,
    0x000fed278f844903ULL, 0x000fed3b10242f4cULL, 0x000fed4dfbad586eULL, 0x000fed605498c3ddULL,
    0x000fed721d414fe8ULL, 0x000fed8357e4a982ULL, 0x000fed9406a42cc8ULL, 0x000feda42b85b704ULL,
    0x000fedb3c8746ab4ULL, 0x000fedc2df416652ULL, 0x000fedd171a46e52ULL, 0x000feddf813c8ad3ULL,
    0x000feded0f909980ULL, 0x000fedfa1e0fd414ULL, 0x000fee06ae124bc4ULL, 0x000fee12c0d95a06ULL,
    0x000fee1e579006e0ULL, 0x000fee29734b6524ULL, 0x000fee34150ae4bcULL, 0x000fee3e3db89b3cULL,
    0x000fee47ee2982f4ULL, 0x000fee51271db086ULL, 0x000fee59e9407f41ULL, 0x000fee623528b42eULL,
    0x000fee6a0b5897f1ULL, 0x000fee716c3e077aULL, 0x000fee7858327b82ULL, 0x000fee7ecf7b06baULL,
    0x000fee84d2484ab2ULL, 0x000fee8a60b66343ULL, 0x000fee8f7accc851ULL, 0x000fee94207e25daULL,
    0x000fee9851a829eaULL, 0x000fee9c0e13485cULL, 0x000fee9f557273f4ULL, 0x000feea22762ccaeULL,
    0x000feea4836b42acULL, 0x000feea668fc2d71ULL, 0x000feea7d76ed6faULL, 0x000feea8ce04fa0aULL,
    0x000feea94be8333bULL, 0x000feea950296410ULL, 0x000feea8d9c0075eULL, 0x000feea7e7897654ULL,
    0x000feea678481d24ULL, 0x000feea48aa29e83ULL, 0x000feea21d22e4daULL, 0x000fee9f2e352024ULL,
    0x000fee9bbc26af2eULL, 0x000fee97c524f2e4ULL, 0x000fee93473c0a3aULL, 0x000fee8e40557516ULL,
    0x000fee88ae369c7aULL, 0x000fee828e7f3dfdULL, 0x000fee7bdea7b888ULL, 0x000fee749bff37ffULL,
    0x000fee6cc3a9bd5eULL, 0x000fee64529e007eULL, 0x000fee5b45a32888ULL, 0x000fee51994e57b6ULL,
    0x000fee474a0006cfULL, 0x000fee3c53e12c50ULL, 0x000fee30b2e02ad8ULL, 0x000fee2462ad8205ULL,
    0x000fee175eb83c5aULL, 0x000fee09a22a1447ULL, 0x000fedfb27e349ccULL, 0x000fedebea76216cULL,
    0x000feddbe422047eULL, 0x000fedcb0ece39d3ULL, 0x000fedb964042cf4ULL, 0x000feda6dce938c9ULL,
    0x000fed937237e98dULL, 0x000fed7f1c38a836ULL, 0x000fed69d2b9c02bULL, 0x000fed538d06ae00ULL,
    0x000fed3c41dea422ULL, 0x000fed23e76a2fd8ULL, 0x000fed0a732fe644ULL, 0x000fecefda07fe34ULL,
    0x000fecd4100eb7b8ULL, 0x000fecb708956eb4ULL, 0x000fec98b61230c1ULL, 0x000fec790a0da978ULL,
    0x000fec57f50f31feULL, 0x000fec356686c962ULL, 0x000fec114cb4b335ULL, 0x000febeb948e6fd0ULL,
    0x000febc429a0b692ULL, 0x000feb9af5ee0cdcULL, 0x000feb6fe1c98542ULL, 0x000feb42d3ad1f9eULL,
    0x000feb13b00b2d4bULL, 0x000feae2591a02e9ULL, 0x000feaaeae992257ULL, 0x000fea788d8ee326ULL,
    0x000fea3fcffd73e5ULL, 0x000fea044c8dd9f6ULL, 0x000fe9c5d62f563bULL, 0x000fe9843ba947a4ULL,
    0x000fe93f471d4728ULL, 0x000fe8f6bd76c5d6ULL, 0x000fe8aa5dc4e8e6ULL, 0x000fe859e07ab1eaULL,
    0x000fe804f690a940ULL, 0x000fe7ab488233c0ULL, 0x000fe74c751f6aa5ULL, 0x000fe6e8102aa202ULL,
    0x000fe67da0b6abd8ULL, 0x000fe60c9f38307eULL, 0x000fe5947338f742ULL, 0x000fe51470977280ULL,
    0x000fe48bd436f458ULL, 0x000fe3f9bffd1e37ULL, 0x000fe35d35eeb19cULL, 0x000fe2b5122fe4feULL,
    0x000fe20003995557ULL, 0x000fe13c82788314ULL, 0x000fe068c4ee67b0ULL, 0x000fdf82b02b71aaULL,
    0x000fde87c57efeaaULL, 0x000fdd7509c63bfdULL, 0x000fdc46e529bf13ULL, 0x000fdaf8f82e0282ULL,
    0x000fd985e1b2ba75ULL, 0x000fd7e6ef48cf04ULL, 0x000fd613adbd650bULL, 0x000fd40149e2f012ULL,
    0x000fd1a1a7b4c7acULL, 0x000fcee204761f9eULL, 0x000fcba8d85e11b2ULL, 0x000fc7d26ecd2d22ULL,
    0x000fc32b2f1e22edULL, 0x000fbd6581c0b83aULL, 0x000fb606c4005434ULL, 0x000fac40582a2874ULL,
    0x000f9e971e014598ULL, 0x000f89fa48a41dfcULL, 0x000f66c5f7f0302cULL, 0x000f1a5a4b331c4aULL,
};
// wi_double (bit patterns)
__device__ const unsigned long long kWi[256] = {
    0x3ccf493b7815d979ULL, 0x3c8b8d0be3fdf6c6ULL, 0x3c9250af3c2c5bb4ULL, 0x3c957cb938443b61ULL,
    0x3c9801fce82fa70cULL, 0x3c9a230c2e4cd0bcULL, 0x3c9c004d2f3861f7ULL, 0x3c9dac2f5a747274ULL,
    0x3c9f32482d4cd5c3ULL, 0x3ca04d32278ebbadULL, 0x3ca0f5053b025d43ULL, 0x3ca192a697413677ULL,
    0x3ca227a28f7a1af5ULL, 0x3ca2b52e3863d880ULL, 0x3ca33c3fc05791f5ULL, 0x3ca3bd9ec1a2b12fULL,
    0x3ca439ef8dff9b55ULL, 0x3ca4b1bb363dfea7ULL, 0x3ca52575621ad374ULL, 0x3ca59580a707ce96ULL,
    0x3ca60231cfd97eeaULL, 0x3ca66bd261a37c3dULL, 0x3ca6d2a292000570ULL, 0x3ca736dad346f8a6ULL,
    0x3ca798ad10b32a77ULL, 0x3ca7f845ad46f543ULL, 0x3ca855cc53430a77ULL, 0x3ca8b1649e7b769aULL,
    0x3ca90b2ea94ecf98ULL, 0x3ca96347822c1eeaULL, 0x3ca9b9c98e38c546ULL, 0x3caa0eccdca4a72cULL,
    0x3caa62676d77cd59ULL, 0x3caab4ad6e101630ULL, 0x3cab05b16d136c9cULL, 0x3cab558487427a29ULL,
    0x3caba4368e529f3aULL, 0x3cabf1d62abf8232ULL, 0x3cac3e70f9594ef3ULL, 0x3cac8a13a5323b61ULL,
    0x3cacd4c9fe72268bULL, 0x3cad1e9f0e80b748ULL, 0x3cad679d29e41f10ULL, 0x3cadafce0023b8c3ULL,
    0x3cadf73aa9f17653ULL, 0x3cae3debb5d2edfeULL, 0x3cae83e9337a6f00ULL, 0x3caec93abdf982ceULL,
    0x3caf0de784f06226ULL, 0x3caf51f654d8f688ULL, 0x3caf956d9e87d7aeULL, 0x3cafd8537dfa2eacULL,
    0x3cb00d56e04234ecULL, 0x3cb02e40f5398f9aULL, 0x3cb04eea9e16a5fcULL, 0x3cb06f565b72a010ULL,
    0x3cb08f869071f40bULL, 0x3cb0af7d84bc6113ULL, 0x3cb0cf3d664bcc7fULL, 0x3cb0eec84b16086bULL,
    0x3cb10e20329515eeULL, 0x3cb12d4707310fbeULL, 0x3cb14c3e9f8e9141ULL, 0x3cb16b08bfc4201eULL,
    0x3cb189a71a78da34ULL, 0x3cb1a81b51ee6d88ULL, 0x3cb1c666f8f82acbULL, 0x3cb1e48b93e0d42eULL,
    0x3cb2028a9940a09fULL, 0x3cb2206572c4c6e9ULL, 0x3cb23e1d7de9c31fULL, 0x3cb25bb40ca96bfbULL,
    0x3cb2792a661dd37fULL, 0x3cb29681c719d71bULL, 0x3cb2b3bb62b82edaULL, 0x3cb2d0d862e1b853ULL,
    0x3cb2edd9e8cba98eULL, 0x3cb30ac10d6e48d7ULL, 0x3cb3278ee1f4b930ULL, 0x3cb3444470265ea1ULL,
    0x3cb360e2baca52d5ULL, 0x3cb37d6abe05586aULL, 0x3cb399dd6fb2b264ULL, 0x3cb3b63bbfb83d03ULL,
    0x3cb3d28698561de0ULL, 0x3cb3eebede725a83ULL, 0x3cb40ae571e09e74ULL, 0x3cb426fb2da6745dULL,
    0x3cb44300e83c30a4ULL, 0x3cb45ef773cac75dULL, 0x3cb47adf9e66c336ULL, 0x3cb496ba32488f2fULL,
    0x3cb4b287f602415dULL, 0x3cb4ce49acb311dcULL, 0x3cb4ea001638a605ULL, 0x3cb505abef5e5562ULL,
    0x3cb5214df20a8b5aULL, 0x3cb53ce6d56a664fULL, 0x3cb558774e1bb2c8ULL, 0x3cb574000e555f78ULL,
    0x3cb58f81c60e8514ULL, 0x3cb5aafd23241b59ULL, 0x3cb5c672d17d733dULL, 0x3cb5e1e37b2f8cd3ULL,
    0x3cb5fd4fc89f5e38ULL, 0x3cb618b860a31fc3ULL, 0x3cb6341de8a2b0a2ULL, 0x3cb64f8104b7260bULL,
    0x3cb66ae257c99672ULL, 0x3cb6864283b13137ULL, 0x3cb6a1a22950b2b1ULL, 0x3cb6bd01e8b343bbULL,
    0x3cb6d8626128d352ULL, 0x3cb6f3c43161f854ULL, 0x3cb70f27f78b68ebULL, 0x3cb72a8e516914c6ULL,
    0x3cb745f7dc70eedcULL, 0x3cb7616535e5731fULL, 0x3cb77cd6faeff449ULL, 0x3cb7984dc8babd93ULL,
    0x3cb7b3ca3c8b1409ULL, 0x3cb7cf4cf3db22fbULL, 0x3cb7ead68c73dee7ULL, 0x3cb80667a486ea1fULL,
    0x3cb82200dac88676ULL, 0x3cb83da2ce899f15ULL, 0x3cb8594e1fd1f5bdULL, 0x3cb875036f7a7ec5ULL,
    0x3cb890c35f47f72dULL, 0x3cb8ac8e9205c043ULL, 0x3cb8c865aba10c9cULL, 0x3cb8e44951446a27ULL,
    0x3cb9003a2973b58fULL, 0x3cb91c38dc288347ULL, 0x3cb9384612ef0afcULL, 0x3cb954627903a28aULL,
    0x3cb9708ebb70d5eeULL, 0x3cb98ccb892e2a31ULL, 0x3cb9a919933f99bfULL, 0x3cb9c5798cd5d92cULL,
    0x3cb9e1ec2b6f7411ULL, 0x3cb9fe7226fad24aULL, 0x3cba1b0c39f93692ULL, 0x3cba37bb21a2c85bULL,
    0x3cba547f9e0bbb88ULL, 0x3cba715a724aa9a4ULL, 0x3cba8e4c64a0313dULL, 0x3cbaab563e9ff108ULL,
    0x3cbac878cd5af5ceULL, 0x3cbae5b4e18bb336ULL, 0x3cbb030b4fc3a11aULL, 0x3cbb207cf09a985bULL,
    0x3cbb3e0aa0e00c00ULL, 0x3cbb5bb541ce3d03ULL, 0x3cbb797db93f8927ULL, 0x3cbb9764f1e5f73cULL,
    0x3cbbb56bdb85256eULL, 0x3cbbd3936b2ec0a2ULL, 0x3cbbf1dc9b81ae83ULL, 0x3cbc10486cec16a0ULL,
    0x3cbc2ed7e5f07a2dULL, 0x3cbc4d8c136e0d1cULL, 0x3cbc6c6608ec8705ULL, 0x3cbc8b66e0eba617ULL,
    0x3cbcaa8fbd36a2abULL, 0x3cbcc9e1c73bd690ULL, 0x3cbce95e3068e037ULL, 0x3cbd0906328b8f6eULL,
    0x3cbd28db1037ef20ULL, 0x3cbd48de1533c647ULL, 0x3cbd691096e7f123ULL, 0x3cbd8973f4d7fba5ULL,
    0x3cbdaa0999206e70ULL, 0x3cbdcad2f8fc490eULL, 0x3cbdebd195522e37ULL, 0x3cbe0d06fb49d21cULL,
    0x3cbe2e74c4ea46f6ULL, 0x3cbe501c99c1d188ULL, 0x3cbe72002f97fe25ULL, 0x3cbe94214b2abf0aULL,
    0x3cbeb681c0f76f08ULL, 0x3cbed9237610a73aULL, 0x3cbefc086101eca9ULL, 0x3cbf1f328ac25321ULL,
    0x3cbf42a40fb74d6dULL, 0x3cbf665f20c90168ULL, 0x3cbf8a6604899782ULL, 0x3cbfaebb187122bfULL,
    0x3cbfd360d22fe785ULL, 0x3cbff859c118f60bULL, 0x3cc00ed447d3a075ULL, 0x3cc021a8028fc947ULL,
    0x3cc034a983a902abULL, 0x3cc047da4e3ef5c7ULL, 0x3cc05b3bf6adb37eULL, 0x3cc06ed023a72668ULL,
    0x3cc082988f632e17ULL, 0x3cc0969708e8a254ULL, 0x3cc0aacd7571c0c4ULL, 0x3cc0bf3dd1eed448ULL,
    0x3cc0d3ea34aa3d30ULL, 0x3cc0e8d4cf116593ULL, 0x3cc0fdffefa69fb6ULL, 0x3cc1136e04207041ULL,
    0x3cc129219bbb5d35ULL, 0x3cc13f1d69c4096dULL, 0x3cc1556448602e3bULL, 0x3cc16bf93b9deef3ULL,
    0x3cc182df74d21261ULL, 0x3cc19a1a564eebacULL, 0x3cc1b1ad777f2f8eULL, 0x3cc1c99ca971a694ULL,
    0x3cc1e1ebfbe4ae39ULL, 0x3cc1fa9fc2e2d901ULL, 0x3cc213bc9d04cc81ULL, 0x3cc22d477a6fd3eeULL,
    0x3cc24745a4ac9c24ULL, 0x3cc261bcc77658e0ULL, 0x3cc27cb2faa8592eULL, 0x3cc2982ecd770e78ULL,
    0x3cc2b437532a0a52ULL, 0x3cc2d0d43196db97ULL, 0x3cc2ee0db1a978f5ULL, 0x3cc30becd256aeeeULL,
    0x3cc32a7b5e68a4a3ULL, 0x3cc349c405ae12a3ULL, 0x3cc369d27a33a840ULL, 0x3cc38ab39256410aULL,
    0x3cc3ac7570ae88faULL, 0x3cc3cf27b31704a6ULL, 0x3cc3f2dbaa60f475ULL, 0x3cc417a49cb9e5daULL,
    0x3cc43d9815545e94ULL, 0x3cc464ce44a73a15ULL, 0x3cc48d62759c43bcULL, 0x3cc4b7739d6b5a27ULL,
    0x3cc4e3250dcd8902ULL, 0x3cc5109f53e9ac41ULL, 0x3cc54011523a7e42ULL, 0x3cc571b1a94ae41bULL,
    0x3cc5a5c08b718dd9ULL, 0x3cc5dc8a243ad0feULL, 0x3cc61669cf861e4cULL, 0x3cc653ce7b006aeaULL,
    0x3cc69540be9fe5c3ULL, 0x3cc6db6b8d09e232ULL, 0x3cc72728f05f7a34ULL, 0x3cc7799556090673ULL,
    0x3cc7d42df4d6ce8cULL, 0x3cc839030529f234ULL, 0x3cc8ab0fbfaa7c14ULL, 0x3cc92ee0946f4496ULL,
    0x3cc9cbee014057abULL, 0x3cca8fdc7894775aULL, 0x3ccb981f3878fdb1ULL, 0x3ccd3bb48209ad33ULL,
};
// fi_double (bit patterns)
__device__ const unsigned long long kFi[256] = {
    0x3ff0000000000000ULL, 0x3fef446ac979f087ULL, 0x3feeb7545b6ca915ULL, 0x3fee3f11e027f077ULL,
    0x3fedd36fa704de95ULL, 0x3fed70920657bcf2ULL, 0x3fed144978a119dcULL, 0x3fecbd33a8a72debULL,
    0x3fec6a5ecea9787fULL, 0x3fec1b1cd9eebaeaULL, 0x3febceeb4ee1dc82ULL, 0x3feb85653a8ff552ULL,
    0x3feb3e3a8234dd10ULL, 0x3feaf92a3f6ce8a2ULL, 0x3feab5fef17a2504ULL, 0x3fea748bd550c9e1ULL,
    0x3fea34aafdf5af0fULL, 0x3fe9f63bee651fd8ULL, 0x3fe9b9228d240681ULL, 0x3fe97d4657617ac1ULL,
    0x3fe94291c21b7a47ULL, 0x3fe908f1bd31714fULL, 0x3fe8d0554fe60aa8ULL, 0x3fe898ad48badf02ULL,
    0x3fe861ebfc37bcacULL, 0x3fe82c050f56cf6eULL, 0x3fe7f6ed4b20e2cbULL, 0x3fe7c29a779c6858ULL,
    0x3fe78f033ca0b0d5ULL, 0x3fe75c1f0770d856ULL, 0x3fe729e5f43f6d12ULL, 0x3fe6f850baea7aeeULL,
    0x3fe6c7589e635a89ULL, 0x3fe696f75e513b2aULL, 0x3fe667272a92e323ULL, 0x3fe637e298550c18ULL,
    0x3fe6092498802665ULL, 0x3fe5dae86f4aff6aULL, 0x3fe5ad29acc85c89ULL, 0x3fe57fe4264c8d8fULL,
    0x3fe55313f08d9e46ULL, 0x3fe526b55a656cd5ULL, 0x3fe4fac4e820b667ULL, 0x3fe4cf3f4f494ec0ULL,
    0x3fe4a42172dc5278ULL, 0x3fe479685fdf5012ULL, 0x3fe44f114a493679ULL, 0x3fe425198a355fe3ULL,
    0x3fe3fb7e99585b82ULL, 0x3fe3d23e10af31a3ULL, 0x3fe3a955a662cd0eULL, 0x3fe380c32bda00d5ULL,
    0x3fe358848bf550e9ULL, 0x3fe33097c9703a35ULL, 0x3fe308fafd6438efULL, 0x3fe2e1ac55ea3beeULL,
    0x3fe2baaa14d7954aULL, 0x3fe293f28e93cd15ULL, 0x3fe26d84290504edULL, 0x3fe2475d5a90db84ULL,
    0x3fe2217ca92ff7f2ULL, 0x3fe1fbe0a9929620ULL, 0x3fe1d687fe549969ULL, 0x3fe1b171573fd111ULL,
    0x3fe18c9b709b3c50ULL, 0x3fe16805128639daULL, 0x3fe143ad105ea99cULL, 0x3fe11f9248311f38ULL,
    0x3fe0fbb3a2325913ULL, 0x3fe0d810104142a0ULL, 0x3fe0b4a68d70d9aeULL, 0x3fe091761d995d81ULL,
    0x3fe06e7dccf03c36ULL, 0x3fe04bbcafa63f2eULL, 0x3fe02931e18b822aULL, 0x3fe006dc85b8cac4ULL,
    0x3fdfc9778c7bbda1ULL, 0x3fdf859da7a900caULL, 0x3fdf4229cb2f7af3ULL, 0x3fdeff1a717e8f95ULL,
    0x3fdebc6e20bd1f54ULL, 0x3fde7a236a4ec3c5ULL, 0x3fde3838ea5f9b85ULL, 0x3fddf6ad47763a09ULL,
    0x3fddb57f320b56b1ULL, 0x3fdd74ad6426de33ULL, 0x3fdd3436a1021080ULL, 0x3fdcf419b4ae5b6dULL,
    0x3fdcb45573c0a848ULL, 0x3fdc74e8bb00d7c7ULL, 0x3fdc35d26f1d2cb8ULL, 0x3fdbf7117c616a17ULL,
    0x3fdbb8a4d6716d91ULL, 0x3fdb7a8b7807131bULL, 0x3fdb3cc462b331caULL, 0x3fdaff4e9ea18552ULL,
    0x3fdac2293a5f5a9eULL, 0x3fda85534aa4d880ULL, 0x3fda48cbea20c04dULL, 0x3fda0c923946843eULL,
    0x3fd9d0a55e1e93dfULL, 0x3fd995048418c0c6ULL, 0x3fd959aedbe09f93ULL, 0x3fd91ea39b33cb17ULL,
    0x3fd8e3e1fcb9f115ULL, 0x3fd8a9693fde9188ULL, 0x3fd86f38a8ac5ab6ULL, 0x3fd8354f7faa0dd9ULL,
    0x3fd7fbad11b8d911ULL, 0x3fd7c250aff414b0ULL, 0x3fd78939af9252ebULL, 0x3fd7506769c7b1edULL,
    0x3fd717d93ba9614cULL, 0x3fd6df8e86124caaULL, 0x3fd6a786ad88de21ULL, 0x3fd66fc11a25cbe2ULL,
    0x3fd6383d377be515ULL, 0x3fd600fa7480d2c8ULL, 0x3fd5c9f84376c244ULL, 0x3fd5933619d6eebeULL,
    0x3fd55cb3703d0100ULL, 0x3fd5266fc2533bedULL, 0x3fd4f06a8ebf6d92ULL, 0x3fd4baa357109ca2ULL,
    0x3fd485199fad6ad4ULL, 0x3fd44fccefc324feULL, 0x3fd41abcd1357a19ULL, 0x3fd3e5e8d08ed2dbULL,
    0x3fd3b1507cf143aeULL, 0x3fd37cf368081379ULL, 0x3fd348d125f9d19eULL, 0x3fd314e94d5af62fULL,
    0x3fd2e13b77210766ULL, 0x3fd2adc73e963fddULL, 0x3fd27a8c414db11eULL, 0x3fd2478a1f17de89ULL,
    0x3fd214c079f7cc9eULL, 0x3fd1e22ef6188116ULL, 0x3fd1afd539c2f050ULL, 0x3fd17db2ed5454e8ULL,
    0x3fd14bc7bb34ee67ULL, 0x3fd11a134fcf2423ULL, 0x3fd0e895598709c4ULL, 0x3fd0b74d88b242daULL,
    0x3fd0863b8f904336ULL, 0x3fd0555f2242e9d9ULL, 0x3fd024b7f6c7747eULL, 0x3fcfe88b89df93c5ULL,
    0x3fcf88108cb83235ULL, 0x3fcf27fe6ce998d2ULL, 0x3fcec854a4c99c44ULL, 0x3fce6912b2283cddULL,
    0x3fce0a3816457184ULL, 0x3fcdabc455c7900aULL, 0x3fcd4db6f8b2514fULL, 0x3fccf00f8a5e6fccULL,
    0x3fcc92cd9971df53ULL, 0x3fcc35f0b7d89d47ULL, 0x3fcbd9787abe18a1ULL, 0x3fcb7d647a8731aaULL,
    0x3fcb21b452ccd13aULL, 0x3fcac667a2571807ULL, 0x3fca6b7e0b19267eULL, 0x3fca10f7322d7e3dULL,
    0x3fc9b6d2bfd2fe5aULL, 0x3fc95d105f6a7c27ULL, 0x3fc903afbf74fa69ULL, 0x3fc8aab09192815bULL,
    0x3fc852128a819a38ULL, 0x3fc7f9d5621f7175ULL, 0x3fc7a1f8d368a323ULL, 0x3fc74a7c9c7ab5a6ULL,
    0x3fc6f3607e964716ULL, 0x3fc69ca43e21f25cULL, 0x3fc64647a2adf19cULL, 0x3fc5f04a76f883f9ULL,
    0x3fc59aac88f31d6cULL, 0x3fc5456da9c86835ULL, 0x3fc4f08dade31fc1ULL, 0x3fc49c0c6cf5ce2dULL,
    0x3fc447e9c20375d5ULL, 0x3fc3f4258b6931aeULL, 0x3fc3a0bfaae8d7eeULL, 0x3fc34db805b4ab88ULL,
    0x3fc2fb0e847c2a65ULL, 0x3fc2a8c3137a071aULL, 0x3fc256d5a2835eb7ULL, 0x3fc2054625183c34ULL,
    0x3fc1b41492757d42ULL, 0x3fc16340e5a82d63ULL, 0x3fc112cb1da26eb9ULL, 0x3fc0c2b33d5209baULL,
    0x3fc072f94bb8bf85ULL, 0x3fc0239d54067d2aULL, 0x3fbfa93ecb6b222cULL, 0x3fbf0bff29520e1cULL,
    0x3fbe6f7bf29aa54bULL, 0x3fbdd3b56176e88fULL, 0x3fbd38abb9bd91e5ULL, 0x3fbc9e5f493b740aULL,
    0x3fbc04d0680b1015ULL, 0x3fbb6bff78f2e233ULL, 0x3fbad3ece9caf633ULL, 0x3fba3c9933ea6286ULL,
    0x3fb9a604dc9d5b19ULL, 0x3fb9103075a4a0abULL, 0x3fb87b1c9dbf2852ULL, 0x3fb7e6ca013eefd6ULL,
    0x3fb753395aaa1176ULL, 0x3fb6c06b73694a4cULL, 0x3fb62e6124854d18ULL, 0x3fb59d1b577466a4ULL,
    0x3fb50c9b06fa2baeULL, 0x3fb47ce1401b2213ULL, 0x3fb3edef23269a86ULL, 0x3fb35fc5e4d93e70ULL,
    0x3fb2d266cf9b3111ULL, 0x3fb245d344dd0d91ULL, 0x3fb1ba0cbe97897dULL, 0x3fb12f14d0f2179dULL,
    0x3fb0a4ed2c159625ULL, 0x3fb01b979e30e497ULL, 0x3faf262c2b6c6e35ULL, 0x3fae16d547b25181ULL,
    0x3fad092efeadf162ULL, 0x3fabfd3e0f282a2cULL, 0x3faaf30790385f70ULL, 0x3fa9ea90f9295563ULL,
    0x3fa8e3e02a68b5abULL, 0x3fa7defb77af271eULL, 0x3fa6dbe9b398d064ULL, 0x3fa5dab23cf2add4ULL,
    0x3fa4db5d0e11275dULL, 0x3fa3ddf2ce98eecbULL, 0x3fa2e27ce83df497ULL, 0x3fa1e9059f1f6abcULL,
    0x3fa0f1982e968011ULL, 0x3f9ff881d718a5c4ULL, 0x3f9e121adb828c75ULL, 0x3f9c301983cd091aULL,
    0x3f9a529f4e22ebf8ULL, 0x3f9879d1b600c10aULL, 0x3f96a5daf40bbf82ULL, 0x3f94d6eaf2fbb064ULL,
    0x3f930d388dab5e13ULL, 0x3f91490334603012ULL, 0x3f8f152a4f72dd49ULL, 0x3f8ba48d274f8facULL,
    0x3f8841040d8da478ULL, 0x3f84eb96421acfe0ULL, 0x3f81a59229952f92ULL, 0x3f7ce160f8ec6837ULL,
    0x3f769ea8d90cb85dULL, 0x3f708a1f03b0b1fdULL, 0x3f655f9f43c1b067ULL, 0x3f54a605b6b9f70fULL,
};

constexpr int kChunk = 512;            // raw draws a chunk
constexpr int kEntries = 4;            // entry offsets a summary covers
constexpr int kWindow = 32;            // token starts kept from the parse from offset 0
constexpr int kThreads = 128;          // threads a block of nf_summary / nf_write
constexpr int kResolveThreads = 512;   // segments of nf_resolve's one block
constexpr int kBatch = 8;              // summary rows a resolve thread loads at once
constexpr int kStage = 32;             // normals a write thread stages before its warp stores them
constexpr int kJumps = 32;             // jumps by kChunk * 2^j, j < kJumps
constexpr unsigned kSaturated = 0xFFFFu;
constexpr int kUnknown = -1;           // an entry offset the scan cannot know
constexpr unsigned long long kMultLo = 0x4385DF649FCCF645ULL;   // PCG64's multiplier
constexpr unsigned long long kMultHi = 0x2360ED051FC65DA4ULL;
constexpr double kZigR = 3.6541528853610087963519472518;        // ziggurat_nor_r
constexpr double kZigInvR = 0.27366123732975827203338247596;    // ziggurat_nor_inv_r

struct U128 {
  unsigned long long lo, hi;
};

// a * b mod 2^128
__host__ __device__ __forceinline__ U128 mul128(U128 a, U128 b) {
#ifdef __CUDA_ARCH__
  const unsigned long long carry = __umul64hi(a.lo, b.lo);
#else
  const unsigned long long carry =
      static_cast<unsigned long long>((static_cast<unsigned __int128>(a.lo) * b.lo) >> 64);
#endif
  return {a.lo * b.lo, carry + a.hi * b.lo + a.lo * b.hi};
}
__host__ __device__ __forceinline__ U128 add128(U128 a, U128 b) {
  const unsigned long long lo = a.lo + b.lo;
  return {lo, a.hi + b.hi + (lo < a.lo ? 1ULL : 0ULL)};
}

struct Params {
  U128 state, inc;          // the generator before the fill's first normal
  long long n;              // normals to write
  long long main;           // kind 0: of them into out, the rest into noise
  long long chunks;         // chunks provisioned
  U128 jump_a[kJumps];      // state after kChunk * 2^j draws = a s + c inc
  U128 jump_c[kJumps];
};

struct Out {
  double* out64;            // kind 0
  double* noise;            // kind 0, normals main .. n - 1 (may be null if main == n)
  float* out32;             // kind 1, (n / d, d)
  const double* centres;    // kind 1, (classes, d)
  const int* labels;        // kind 1, (n / d,)
  int d;
};

// PCG64 one draw ahead: the next draw's 128-bit step runs while the
// caller works on this one (the step is the longest chain of a token)
struct Pcg {
  U128 s, inc;
  unsigned long long ahead;   // the draw next() returns
  __device__ __forceinline__ void step() {
    s = add128(mul128(s, U128{kMultLo, kMultHi}), inc);
    const unsigned long long v = s.hi ^ s.lo;
    const unsigned rot = static_cast<unsigned>(s.hi >> 58);
    ahead = (v >> rot) | (v << ((64u - rot) & 63u));
  }
  __device__ __forceinline__ unsigned long long next() {
    const unsigned long long r = ahead;
    step();
    return r;
  }
  __device__ __forceinline__ double next_double() {
    return __dmul_rn(__ull2double_rn(next() >> 11), 1.0 / 9007199254740992.0);
  }
};

// the generator at draw c * kChunk
__device__ __forceinline__ Pcg at_chunk(const Params& p, long long c) {
  U128 s = p.state;
#pragma unroll
  for (int j = 0; j < kJumps; ++j) {
    if ((c >> j) & 1) s = add128(mul128(p.jump_a[j], s), mul128(p.jump_c[j], p.inc));
  }
  Pcg g{s, p.inc, 0};
  g.step();
  return g;
}

struct Zig {
  unsigned long long ki[256];
  double wi[256];
  double fi[256];
};

__device__ __forceinline__ void load_zig(Zig& z) {
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    z.ki[i] = kKi[i];
    z.wi[i] = __longlong_as_double(static_cast<long long>(kWi[i]));
    z.fi[i] = __longlong_as_double(static_cast<long long>(kFi[i]));
  }
  __syncthreads();
}

// One attempt of random_standard_normal from where g stands: whether it
// makes a normal (then *z), and the draws it read (*len).
__device__ __forceinline__ bool token(Pcg& g, const Zig& t, double* z, int* len) {
  const unsigned long long r = g.next();
  const int idx = static_cast<int>(r & 0xff);
  const unsigned long long rabs = (r >> 9) & 0x000fffffffffffffULL;
  double x = __dmul_rn(__ull2double_rn(rabs), t.wi[idx]);
  if (r & 0x100) x = -x;
  *z = x;
  if (rabs < t.ki[idx]) {
    *len = 1;
    return true;
  }
  if (idx == 0) {
    int k = 1;
    for (;;) {
      const double xx = __dmul_rn(-kZigInvR, log1p(-g.next_double()));
      const double yy = -log1p(-g.next_double());
      k += 2;
      if (__dadd_rn(yy, yy) > __dmul_rn(xx, xx)) {
        const double v = __dadd_rn(xx, kZigR);
        *z = ((rabs >> 8) & 1) ? -v : v;
        *len = k;
        return true;
      }
    }
  }
  const double u = g.next_double();
  *len = 2;
  const double lhs = __dadd_rn(__dmul_rn(__dsub_rn(t.fi[idx - 1], t.fi[idx]), u), t.fi[idx]);
  return lhs < exp(__dmul_rn(__dmul_rn(-0.5, x), x));
}

__device__ __forceinline__ unsigned pack(int made, int exit) {
  return static_cast<unsigned>(made) | (min(static_cast<unsigned>(exit), kSaturated) << 16);
}

// (normals, exit offset) of chunk c parsed from entry offset `entry`: the
// rare serial re-parse, kept out of line
__device__ __noinline__ void parse_chunk(const Params& p, const Zig& t, long long c, int entry, int* made,
                            int* exit) {
  Pcg g = at_chunk(p, c);
  for (int i = 0; i < entry; ++i) g.next();
  int q = entry, k = 0;
  while (q < kChunk) {
    double z;
    int len;
    k += token(g, t, &z, &len);
    q += len;
  }
  *made = k;
  *exit = q - kChunk;
}

__global__ void __launch_bounds__(kThreads) nf_summary(const __grid_constant__ Params p,
                                                       uint4* __restrict__ rows) {
  __shared__ Zig zig;
  load_zig(zig);
  const long long c = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= p.chunks) return;
  const Pcg g0 = at_chunk(p, c);
  Pcg g = g0;
  unsigned starts = 0, outs = 0;
  int q = 0, made0 = 0;
  while (q < kChunk) {
    double z;
    int len;
    const bool made = token(g, zig, &z, &len);
    if (q < kWindow) {
      starts |= 1u << q;
      outs |= static_cast<unsigned>(made) << q;
    }
    made0 += made;
    q += len;
  }
  const int exit0 = q - kChunk;
  unsigned w[kEntries];
  w[0] = pack(made0, exit0);
#pragma unroll
  for (int e = 1; e < kEntries; ++e) {
    if ((starts >> e) & 1u) {      // offset e starts a token of the parse from 0
      w[e] = pack(made0 - __popc(outs & ((1u << e) - 1u)), exit0);
      continue;
    }
    Pcg h = g0;
    for (int i = 0; i < e; ++i) h.next();
    int qe = e, k = 0;
    for (;;) {
      if (qe >= kChunk) {
        w[e] = pack(k, qe - kChunk);
        break;
      }
      if (qe < kWindow && ((starts >> qe) & 1u)) {
        w[e] = pack(k + made0 - __popc(outs & ((1u << qe) - 1u)), exit0);
        break;
      }
      double z;
      int len;
      k += token(h, zig, &z, &len);
      qe += len;
    }
  }
  rows[c] = make_uint4(w[0], w[1], w[2], w[3]);
}

// entry offset -> (exit offset, normals) over a run of chunks.  A flat
// map stands for a segment entered at the one offset it knows: it takes
// any entry; another map only those below kEntries.
struct Map {
  int cur[kEntries];
  int acc[kEntries];
  int flat;
};

__device__ __forceinline__ int pick(const int (&a)[kEntries], int k) {
  int r = a[0];
#pragma unroll
  for (int i = 1; i < kEntries; ++i) r = k == i ? a[i] : r;
  return r;
}

__device__ __forceinline__ Map identity_map() {
  Map m;
#pragma unroll
  for (int e = 0; e < kEntries; ++e) {
    m.cur[e] = e;
    m.acc[e] = 0;
  }
  m.flat = 0;
  return m;
}

// f, then g; an entry offset g does not take makes the exit unknown
__device__ __forceinline__ Map compose(const Map& f, const Map& g) {
  Map h;
#pragma unroll
  for (int e = 0; e < kEntries; ++e) {
    const int c = f.cur[e];
    const bool known = c != kUnknown && (g.flat || c < kEntries);
    const int k = g.flat ? 0 : c;
    h.cur[e] = known ? pick(g.cur, k) : kUnknown;
    h.acc[e] = known ? f.acc[e] + pick(g.acc, k) : 0;
  }
  h.flat = f.flat;
  return h;
}

__device__ __forceinline__ Map shfl_up(const Map& m, int off) {
  Map r;
#pragma unroll
  for (int e = 0; e < kEntries; ++e) {
    r.cur[e] = __shfl_up_sync(0xffffffffu, m.cur[e], off);
    r.acc[e] = __shfl_up_sync(0xffffffffu, m.acc[e], off);
  }
  r.flat = __shfl_up_sync(0xffffffffu, m.flat, off);
  return r;
}

__device__ __forceinline__ Map warp_scan(Map m, int lane) {   // inclusive
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Map f = shfl_up(m, off);
    if (lane >= off) m = compose(f, m);
  }
  return m;
}

// chunk j's summary row read from entry offset cur: cur and acc move on
__device__ __forceinline__ void step(const Params& p, const Zig& t, const uint4& row, long long j,
                                     int& cur, int& acc, unsigned& reparsed) {
  const unsigned w = cur == 0 ? row.x : cur == 1 ? row.y : cur == 2 ? row.z : row.w;
  if (cur < kEntries && (w >> 16) != kSaturated) {
    acc += static_cast<int>(w & 0xFFFFu);
    cur = static_cast<int>(w >> 16);
    return;
  }
  int made, exit;
  parse_chunk(p, t, j, cur, &made, &exit);
  acc += made;
  cur = exit;
  ++reparsed;
}

__global__ void __launch_bounds__(kResolveThreads) nf_resolve(const __grid_constant__ Params p,
                                                              uint4* __restrict__ rows,
                                                              unsigned long long* reparses) {
  __shared__ Zig zig;
  __shared__ Map warp_prefix[kResolveThreads / 32];
  __shared__ int unknown;
  load_zig(zig);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long per = (p.chunks + kResolveThreads - 1) / kResolveThreads;
  const long long lo = tid * per, hi = min(lo + per, p.chunks);
  unsigned reparsed = 0;
  Map m = identity_map();
  for (long long j0 = lo; j0 < hi; j0 += kBatch) {
    uint4 batch[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (j0 + b < hi) batch[b] = rows[j0 + b];
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (j0 + b < hi) {
#pragma unroll
        for (int e = 0; e < kEntries; ++e) {
          step(p, zig, batch[b], j0 + b, m.cur[e], m.acc[e], reparsed);
        }
      }
    }
  }
  // rounds of scans: a segment whose entry is known but past kEntries
  // walks from it and stands in for it (a flat map) in the next round;
  // each round settles the first such boundary
  int entry = 0, base = 0;
  bool fixed = false;
  for (int round = 0; round <= kResolveThreads; ++round) {
    const Map inclusive = warp_scan(m, lane);
    if (tid == 0) unknown = 0;
    if (lane == 31) warp_prefix[warp] = inclusive;
    __syncthreads();
    if (warp == 0) {
      constexpr int kWarps = kResolveThreads / 32;
      const Map total = warp_scan(lane < kWarps ? warp_prefix[lane] : identity_map(), lane);
      Map before = shfl_up(total, 1);
      if (lane == 0) before = identity_map();
      __syncwarp();
      if (lane < kWarps) warp_prefix[lane] = before;
    }
    __syncthreads();
    const Map before = shfl_up(inclusive, 1);
    const Map prefix = lane == 0 ? warp_prefix[warp] : compose(warp_prefix[warp], before);
    entry = prefix.cur[0];
    base = prefix.acc[0];
    if (lo < hi && entry == kUnknown) atomicOr(&unknown, 1);
    __syncthreads();
    if (!unknown) break;
    if (lo < hi && !fixed && entry >= kEntries) {
      int cur = entry, made = 0;
      for (long long j = lo; j < hi; ++j) step(p, zig, rows[j], j, cur, made, reparsed);
#pragma unroll
      for (int e = 0; e < kEntries; ++e) {
        m.cur[e] = cur;
        m.acc[e] = made;
      }
      m.flat = 1;
      fixed = true;
    }
    __syncthreads();
  }
  // rounds that ended with an entry still unknown: flagged beside the
  // re-parses, where the host reads them (never seen; the rounds settle
  // a boundary each)
  if (tid == 0 && unknown) atomicAdd(reparses + 1, 1ULL);
  for (long long j0 = lo; j0 < hi; j0 += kBatch) {
    uint4 batch[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (j0 + b < hi) batch[b] = rows[j0 + b];
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (j0 + b < hi) {
        rows[j0 + b] = make_uint4(static_cast<unsigned>(base), static_cast<unsigned>(entry), 0u, 0u);
        step(p, zig, batch[b], j0 + b, entry, base, reparsed);
      }
    }
  }
  if (reparsed) atomicAdd(reparses, static_cast<unsigned long long>(reparsed));
}

template <int kKind>
struct Value {
  using T = double;
};
template <>
struct Value<1> {
  using T = float;
};

// normal i of the fill, already through the epilogue, to its place
template <int kKind>
__device__ __forceinline__ void put(const Params& p, const Out& o, long long i,
                                    typename Value<kKind>::T v) {
  if constexpr (kKind == 1) {
    o.out32[i] = v;
  } else if (i < p.main) {
    o.out64[i] = v;
  } else {
    o.noise[i - p.main] = v;
  }
}

// A thread a chunk parses its tokens again from its entry offset.  Each
// thread stages its normals (through the epilogue) in its own row of
// shared memory; whenever rows are full, the warp stores each of them as
// kStage consecutive elements, one a lane, so that every store is
// coalesced (a thread's own normals are consecutive, but 32 threads'
// are a chunk apart).
template <int kKind>
__global__ void __launch_bounds__(kThreads) nf_write(const __grid_constant__ Params p,
                                                     const uint4* __restrict__ rows, Out o) {
  using T = typename Value<kKind>::T;
  __shared__ Zig zig;
  __shared__ T stage[kThreads][kStage + 1];   // + 1: a lane's column in its own bank
  load_zig(zig);
  const int lane = threadIdx.x & 31, warp0 = threadIdx.x & ~31;
  const long long j = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  long long i = p.n;
  int q = kChunk;
  if (j < p.chunks) {
    const uint4 head = rows[j];
    i = head.x;
    q = static_cast<int>(head.y);
  }
  const bool last = j == p.chunks - 1;
  bool active = i < p.n;
  Pcg g{};
  long long row = 0;
  int col = 0;
  const double* centre = nullptr;
  if (active) {
    g = at_chunk(p, j);
    for (int s = 0; s < q; ++s) g.next();
    if constexpr (kKind == 1) {
      row = i / o.d;
      col = static_cast<int>(i - row * o.d);
      centre = o.centres + static_cast<long long>(o.labels[row]) * o.d;
    }
  }
  long long first = i;   // the index of the normal in stage column 0
  int staged = 0;
  T* mine = stage[threadIdx.x];
  while (__any_sync(0xffffffffu, active)) {
    if (active) {
      double z;
      int len;
      const bool made = token(g, zig, &z, &len);
      q += len;
      if (made) {
        if constexpr (kKind == 1) {
          mine[staged] = __double2float_rn(__dadd_rn(centre[col], z));
          if (++col == o.d && i + 1 < p.n) {
            col = 0;
            ++row;
            centre = o.centres + static_cast<long long>(o.labels[row]) * o.d;
          }
        } else {
          mine[staged] = z;
        }
        ++staged;
        ++i;
      }
      active = i < p.n && (q < kChunk || last);
    }
    unsigned full = __ballot_sync(0xffffffffu, staged == kStage);
    if (full) {
      __syncwarp();
      while (full) {
        const int l = __ffs(full) - 1;
        full &= full - 1;
        put<kKind>(p, o, __shfl_sync(0xffffffffu, first, l) + lane, stage[warp0 + l][lane]);
      }
      __syncwarp();
      if (staged == kStage) {
        staged = 0;
        first = i;
      }
    }
  }
  __syncwarp();
  for (int l = 0; l < 32; ++l) {
    const int count = __shfl_sync(0xffffffffu, staged, l);
    const long long at = __shfl_sync(0xffffffffu, first, l);
    if (lane < count) put<kKind>(p, o, at + lane, stage[warp0 + l][lane]);
  }
}

struct Jumps {
  U128 a[kJumps], c[kJumps];
};

// (A, C) of kChunk * 2^j draws: A = M^delta, C = sum_{i < delta} M^i
const Jumps& jumps() {
  static const Jumps table = [] {
    Jumps t{};
    const U128 m{kMultLo, kMultHi}, one{1, 0};
    U128 a = one, c{0, 0};
    for (int i = 0; i < kChunk; ++i) {
      a = mul128(a, m);
      c = add128(mul128(c, m), one);
    }
    for (int j = 0; j < kJumps; ++j) {
      t.a[j] = a;
      t.c[j] = c;
      c = mul128(c, add128(a, one));
      a = mul128(a, a);
    }
    return t;
  }();
  return table;
}

}  // namespace

// Fill n normals of the PCG64 stream at (state, inc) on `stream`: kind 0
// writes float64 into out (the first main) and noise (the rest); kind 1
// writes float32(centres[labels[i / d] * d + i % d] + z_i) into out.
// `rows` is scratch of chunks x kEntries words; `reparses` two device
// counters: the chunks re-parsed serially are added to the first, a
// resolve that left an entry unknown to the second.  Returns a
// cudaError_t.
extern "C" int normal_fill_launch(unsigned long long state_lo, unsigned long long state_hi,
                                  unsigned long long inc_lo, unsigned long long inc_hi,
                                  long long n, long long main, int kind, long long chunks,
                                  void* rows, void* reparses, void* out, void* noise,
                                  const void* centres, const void* labels, int d, void* stream) {
  if (n < 1 || n > 0x7FFFFFFFLL || chunks < 1 || chunks >= (1LL << kJumps) || main < 0 || main > n ||
      (kind == 0 && main < n && noise == nullptr) || (kind == 1 && (d < 1 || n % d != 0)) ||
      (kind != 0 && kind != 1)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params p;
  p.state = {state_lo, state_hi};
  p.inc = {inc_lo, inc_hi};
  p.n = n;
  p.main = main;
  p.chunks = chunks;
  const Jumps& j = jumps();
  for (int i = 0; i < kJumps; ++i) {
    p.jump_a[i] = j.a[i];
    p.jump_c[i] = j.c[i];
  }
  Out o{};
  o.out64 = static_cast<double*>(out);
  o.noise = static_cast<double*>(noise);
  o.out32 = static_cast<float*>(out);
  o.centres = static_cast<const double*>(centres);
  o.labels = static_cast<const int*>(labels);
  o.d = d;
  uint4* r = static_cast<uint4*>(rows);
  const unsigned blocks = static_cast<unsigned>((chunks + kThreads - 1) / kThreads);
  nf_summary<<<blocks, kThreads, 0, s>>>(p, r);
  nf_resolve<<<1, kResolveThreads, 0, s>>>(p, r, static_cast<unsigned long long*>(reparses));
  if (kind == 0) {
    nf_write<0><<<blocks, kThreads, 0, s>>>(p, r, o);
  } else {
    nf_write<1><<<blocks, kThreads, 0, s>>>(p, r, o);
  }
  return cudaGetLastError();
}
